"""Hand-written CUDA kernels for Hopper, each behind a
`torch.autograd.Function` with a plain PyTorch version beside it."""

from .fused_em import FusedEM, fused_em_solve, supports_fused

__all__ = ["FusedEM", "fused_em_solve", "supports_fused"]
