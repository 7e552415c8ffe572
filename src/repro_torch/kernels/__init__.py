"""repro_torch.kernels — the hand-written CUDA kernels (``csrc/``), each
beside its plain PyTorch version, and the row plumbing around them.

Kernel libraries are built on first use (``_build``), never at import."""
