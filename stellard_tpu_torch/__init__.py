"""PyTorch/CUDA port of stellard-tpu's device plane.

The ledger close hands the accelerator two kinds of work: batched
Ed25519 signature verification (``node.verifyplane`` over
``crypto.backend.CudaVerifier``) and the SHA-512-half seal of every dirty
SHAMap node (``crypto.backend.CudaHasher.hash_tree``). Both run on
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.

This package imports ``torch`` and never ``jax`` or ``stellard_tpu``.
"""
