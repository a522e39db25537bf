"""Hand-written CUDA kernels for Hopper, each behind a
`torch.autograd.Function` with a plain PyTorch version beside it."""

from .fused_cde import FusedCDE, fused_cde_solve, supports_fused_cde
from .fused_em import FusedEM, fused_em_solve, supports_fused
from .fused_rnn import (FusedGRU, FusedLSTM, fused_gru_scan, fused_lstm_scan,
                        supports_fused_gru, supports_fused_lstm)
from .fused_srk import FusedSRK, fused_srk_solve, supports_fused_srk

__all__ = ["FusedCDE", "fused_cde_solve", "supports_fused_cde", "FusedEM",
           "fused_em_solve", "supports_fused", "FusedGRU", "FusedLSTM",
           "fused_gru_scan", "fused_lstm_scan", "supports_fused_gru",
           "supports_fused_lstm", "FusedSRK", "fused_srk_solve",
           "supports_fused_srk"]
