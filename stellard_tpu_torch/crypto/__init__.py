"""Crypto plane: the backend registry and the CUDA verifier/hasher."""

from .backend import (
    BatchHasher,
    BatchVerifier,
    CpuHasher,
    CpuVerifier,
    CudaHasher,
    CudaVerifier,
    TransferMeter,
    VerifyRequest,
    make_hasher,
    make_verifier,
    register_hasher,
    register_verifier,
)
