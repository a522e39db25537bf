"""Brownian increments and the space-time Lévy area (counterpart of
snsde/ops/brownian.py:27-101).

The JAX package draws its increments from JAX's RBG generator, whose bits
torch cannot reproduce; here they come from an explicit `torch.Generator`.
Parity tests therefore draw dW (and the Lévy area) with numpy and inject
them on both sides through `BrownianGrid` (`sdeint(bm=...)`),
`fused_em_solve(dW_override=)` or `fused_srk_solve(brownian_override=)`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["brownian_increments", "space_time_levy_area", "BrownianGrid"]


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


def space_time_levy_area(generator: Optional[torch.Generator], grid,
                         shape: Tuple[int, ...],
                         dW: torch.Tensor) -> torch.Tensor:
    """The space-time Lévy area the order-1.5 SRK scheme needs, given dW
    over the grid: U_k = dt_k/2 (dW_k + dZ_k/sqrt(3)) with an independent
    dZ_k ~ N(0, dt_k), in dW's dtype and on its device. Then E[U] = 0,
    Var U = dt^3/3 and E[U dW] = dt^2/2."""
    dts = np.diff(np.asarray(grid, np.float64))
    m = dts.shape[0]
    dZ = torch.randn((m,) + tuple(shape), generator=generator, dtype=dW.dtype,
                     device=dW.device)
    bshape = (m,) + (1,) * len(shape)
    sd = torch.as_tensor(np.sqrt(dts), dtype=dW.dtype,
                         device=dW.device).reshape(bshape)
    dt = torch.as_tensor(dts, dtype=dW.dtype, device=dW.device).reshape(bshape)
    return 0.5 * dt * (dW + (dZ * sd) / math.sqrt(3.0))


@dataclasses.dataclass(frozen=True)
class BrownianGrid:
    """Pre-sampled Brownian increments bound to a step grid: grid [M+1]
    (host), dW [M, *shape], and the Lévy area U [M, *shape] that the srk
    method needs (None for euler)."""

    grid: np.ndarray
    dW: torch.Tensor
    U: Optional[torch.Tensor] = None
