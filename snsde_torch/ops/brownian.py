"""Brownian increments (counterpart of snsde/ops/brownian.py:27-101).

The JAX package draws its increments from JAX's RBG generator, whose bits
torch cannot reproduce; here they come from an explicit `torch.Generator`.
Parity tests therefore draw dW with numpy and inject it on both sides
through `BrownianGrid` (`sdeint(bm=...)`) or `fused_em_solve(dW_override=)`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["brownian_increments", "BrownianGrid"]


def brownian_increments(generator: Optional[torch.Generator], grid,
                        shape: Tuple[int, ...], dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """dW over a host step grid [M+1]: [M, *shape] with
    dW_k ~ N(0, grid[k+1] - grid[k]). The generator must live on `device`."""
    dts = np.diff(np.asarray(grid, np.float64))
    m = dts.shape[0]
    eps = torch.randn((m,) + tuple(shape), generator=generator, dtype=dtype,
                      device=device)
    scale = torch.as_tensor(np.sqrt(dts), dtype=dtype, device=device)
    return eps * scale.reshape((m,) + (1,) * len(shape))


@dataclasses.dataclass(frozen=True)
class BrownianGrid:
    """Pre-sampled Brownian increments bound to a step grid: grid [M+1]
    (host), dW [M, *shape]. The Lévy area (U) waits for the SRK solver."""

    grid: np.ndarray
    dW: torch.Tensor
