"""Crypto plane: the backend registry, the CUDA verifier/hasher and the
path-quality evaluator."""

from .backend import (
    BatchHasher,
    BatchVerifier,
    CpuHasher,
    CpuVerifier,
    CudaHasher,
    CudaVerifier,
    PathQualityEvaluator,
    TransferMeter,
    VerifyRequest,
    make_hasher,
    make_path_evaluator,
    make_verifier,
    register_hasher,
    register_verifier,
)
