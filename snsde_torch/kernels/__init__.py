"""Hand-written CUDA kernels for Hopper, each behind a
`torch.autograd.Function` with a plain PyTorch version beside it."""

from .fused_em import FusedEM, fused_em_solve, supports_fused
from .fused_srk import FusedSRK, fused_srk_solve, supports_fused_srk

__all__ = ["FusedEM", "fused_em_solve", "supports_fused", "FusedSRK",
           "fused_srk_solve", "supports_fused_srk"]
