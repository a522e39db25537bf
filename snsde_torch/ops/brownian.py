"""Brownian increments, the space-time Lévy area and the Virtual Brownian
Tree (counterpart of snsde/ops/brownian.py:27-181).

The JAX package draws its increments from JAX's RBG generator, whose bits
torch cannot reproduce; here they come from an explicit `torch.Generator`.
Parity tests therefore draw dW (and the Lévy area) with numpy and inject
them on both sides through `BrownianGrid` (`sdeint(bm=...)`),
`fused_em_solve(dW_override=)` or `fused_srk_solve(brownian_override=)`.

Inside a data-parallel row shard (`parallel/data_parallel.py`) the
increments and the Lévy area are drawn for the global batch and this
rank's rows kept, so every row gets the draw one process would give it.

The Virtual Brownian Tree keys each node's draw by (seed, node, element)
through a counter-based hash written in torch integer ops, so W(t) is a
pure function of (seed, t), the same on the CPU and on the card; its
`normals` seam takes the node draws from a callable instead (the parity
tests feed the port and the JAX package one table of draws).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.data_parallel import draw_rows

__all__ = ["brownian_increments", "space_time_levy_area", "BrownianGrid",
           "VirtualBrownianTree", "counter_normals"]


def brownian_increments(generator: Optional[torch.Generator], grid,
                        shape: Tuple[int, ...], dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """dW over a host step grid [M+1]: [M, *shape] with
    dW_k ~ N(0, grid[k+1] - grid[k]). The generator must live on `device`."""
    dts = np.diff(np.asarray(grid, np.float64))
    m = dts.shape[0]
    eps = draw_rows(lambda s: torch.randn(s, generator=generator,
                                          dtype=dtype, device=device),
                    (m,) + tuple(shape), dim=1)
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
    dZ = draw_rows(lambda s: torch.randn(s, generator=generator,
                                         dtype=dW.dtype, device=dW.device),
                   (m,) + tuple(shape), dim=1)
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


_M32 = 0xFFFFFFFF


def _host_float(dtype):
    """The numpy scalar type whose arithmetic the host side of a solve in
    `dtype` follows (the JAX package's device scalars of that dtype)."""
    return np.float64 if dtype == torch.float64 else np.float32


def _mul32(x, c: int):
    """(x c) mod 2^32 for x in [0, 2^32) (an int64 tensor or a Python int)
    and a 32-bit constant c, with no product past 2^48: x is split into
    16-bit halves."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash with full avalanche (Wellons' lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_normals(seed: int, nodes: Sequence[int], shape: Tuple[int, ...],
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Standard normals [len(nodes), *shape] keyed by (seed, node,
    element): element e of a node takes the 32-bit hashes of the counters
    2e and 2e + 1 under the (seed, node) key as two uniforms, then
    Box–Muller in float64. The same numbers on every device and in any
    order of calls; every node's in one pass."""
    seed_key = _mix32(seed & _M32) ^ (seed >> 32 & _M32)
    keys = torch.tensor([_mix32(seed_key + _mul32(n & _M32, 0x9E3779B9)
                                & _M32) for n in nodes],
                        dtype=torch.int64, device=device)[:, None]
    n = math.prod(shape)
    c = torch.arange(2 * n, dtype=torch.int64, device=device)
    bits = _mix32(_mix32((c + keys) & _M32) ^ keys)
    u = (bits.double() + 0.5) * 2.0 ** -32               # (0, 1)
    u1, u2 = u[:, 0::2], u[:, 1::2]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.reshape((len(nodes),) + tuple(shape)).to(dtype)


class VirtualBrownianTree:
    """W(t) at any t in [t0, t1] by bridge bisection to `depth` levels
    (snsde/ops/brownian.py:103-181): W(t0) = 0, W(t1) ~ N(0, t1 - t0) from
    node 1, then at each level the midpoint of the current interval from
    the Brownian bridge, N((ws + we)/2, span/4), with its normals from
    node n (the root 2, children 2n and 2n + 1), and linear interpolation
    inside the leaf; the endpoints exact. The descent runs on the host in
    `dtype`'s precision, the arithmetic of the JAX package's traced one:
    which way it goes depends on t alone, so a query draws its nodes'
    normals in one call, on `device`.

    W(t) is a pure function of (seed, t): the same query gives the same
    value in any order, which is what an adaptive solver's step rejection
    needs. `normals(nodes) -> [len(nodes), *shape]` replaces the
    counter-based draws (`counter_normals`) when given."""

    def __init__(self, t0: float, t1: float, shape: Tuple[int, ...], *,
                 seed: int = 0, depth: int = 18, dtype=torch.float32,
                 device=None,
                 normals: Optional[Callable[[Sequence[int]],
                                            torch.Tensor]] = None):
        if t1 <= t0:
            raise ValueError("need t1 > t0")
        self.t0, self.t1, self.shape = float(t0), float(t1), tuple(shape)
        self.depth, self.dtype, self.device = depth, dtype, device
        self._normals = normals or (lambda nodes: counter_normals(
            seed, nodes, self.shape, dtype, device))

    def _draw(self, nodes) -> torch.Tensor:
        return torch.as_tensor(self._normals(nodes), dtype=self.dtype,
                               device=self.device)

    def evaluate(self, t) -> torch.Tensor:
        """W(t) for one host time t -> [*shape]."""
        f32 = _host_float(self.dtype)
        t = f32(t)
        if t <= f32(self.t0):
            return torch.zeros(self.shape, dtype=self.dtype,
                               device=self.device)
        sd1 = float(np.sqrt(f32(self.t1 - self.t0)))
        if t >= f32(self.t1):
            return self._draw([1])[0] * sd1
        # the descent: each level's node, its bridge's deviation and the
        # side t lies on
        s, e, node, levels = f32(self.t0), f32(self.t1), 2, []
        for _ in range(self.depth):
            m = f32(0.5) * (s + e)
            left = bool(t < m)
            levels.append((node, float(np.sqrt(f32(0.25) * (e - s))), left))
            s, e = (s, m) if left else (m, e)
            node = 2 * node if left else 2 * node + 1
        z = self._draw([1] + [lv[0] for lv in levels])
        we = z[0] * sd1
        ws = torch.zeros_like(we)
        for zi, (_, sd, left) in zip(z[1:], levels):
            wm = 0.5 * (ws + we) + zi * sd
            ws, we = (ws, wm) if left else (wm, we)
        frac = np.clip((t - s) / max(e - s, f32(1e-30)), f32(0), f32(1))
        return ws + float(frac) * (we - ws)

    __call__ = evaluate
