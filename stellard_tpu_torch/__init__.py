"""PyTorch/CUDA port of stellard-tpu's device plane.

The ledger close hands the accelerator two kinds of work: batched
Ed25519 signature verification (``node.verifyplane`` over
``crypto.backend.CudaVerifier``) and the SHA-512-half seal of every dirty
SHAMap node (``crypto.backend.CudaHasher.hash_tree``); the path search
hands it a third, the Q16.16 pre-rank of oversized candidate sets
(``paths.plane.PathPlane`` over ``crypto.backend.PathQualityEvaluator``).
All run on hand-written CUDA kernels for Hopper (``csrc/``), built with
``nvcc`` at first use; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead. Around them, the host modules of a standalone
node (``protocol/``, ``state/``, ``engine/`` with every transactor,
``paths/``, the serial ``node.ledgermaster`` close) are the JAX
package's, carried over byte for byte.

This package imports ``torch`` and never ``jax`` or ``stellard_tpu``.
"""
