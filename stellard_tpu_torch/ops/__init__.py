"""Device ops: the CUDA kernels' wrappers (K1 ``ed25519_cuda``, K2/K3
``treehash``), their plain PyTorch versions, and host prep."""
