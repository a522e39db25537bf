"""Seed ensembles trained through one member-axis launch (counterpart of
snsde/models/ensemble.py:36-290).

The reference repeats one model configuration over seeds (5 repeats a
cell of the classification grids, 5 seeds a cell of the robustness sweep)
and trains each replica in its own process. A seed ensemble trains K
same-configuration replicas at once: on CUDA tensors the SDE solve (euler
or srk), the whole hot loop, is one launch of the EM or SRK kernels with
a member axis (kernels/multi.py; a CDE ensemble's, of the CDE kernels),
while the members' small initial networks and readout heads run as
ordinary per-member modules. Each member is a submodule, so
`state_dict` and `convert.py` see the JAX package's leaves.

Members are independent: each draws its Brownian increments and its
dropout masks from its own generator, exactly what a solo model driven by
that generator draws (the solve's increments first, then the readout's
mask), so member i of an ensemble is the solo model run on generator i.
On CPU tensors, and for the SDE methods no kernel takes (milstein, heun,
reversible_heun), every member is solved by its own eager solve, as the
JAX package does off its accelerator.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..kernels.fused_cde import supports_fused_cde
from ..kernels.multi import (fused_cde_solve_packed, fused_em_solve_packed,
                             fused_srk_solve_packed)
from ..nn.layers import make_linear
from ..ops.interp import CubicPath
from ..ops.solve import cdeint
from .neuralsde import ReadoutHead, resolve_dt, solve_dispatch

__all__ = ["SeedEnsemble", "packed_solve", "packed_cde_solve", "IVMember",
           "InitialValueSeedEnsemble"]


def packed_solve(fields: Sequence, path, times, y0s: torch.Tensor,
                 generators: Sequence[torch.Generator], *,
                 method: str = "euler", dt: Optional[float] = None,
                 paths=None) -> torch.Tensor:
    """K members' solve (ensemble.py:133-163): on CUDA tensors with euler
    or srk one launch of the member-axis kernels (the EM pair, the SRK
    pair); every other case, CPU tensors and the methods no kernel takes
    (milstein, heun, reversible_heun), each member's own solve through
    `solve_dispatch` on its own generator, as the JAX package solves off
    its accelerator. `generators` holds each member's generator, `paths`
    each member's own control path (else all read `path`). Returns
    [K, T, B, H]."""
    dt = resolve_dt(times) if dt is None else dt
    if y0s.device.type == "cuda" and method == "euler":
        return fused_em_solve_packed(list(fields), path, times, y0s,
                                     list(generators), dt=dt, paths=paths)
    if y0s.device.type == "cuda" and method == "srk":
        return fused_srk_solve_packed(list(fields), path, times, y0s,
                                      list(generators), dt=dt, paths=paths)
    member_paths = paths if paths is not None else [path] * len(fields)
    return torch.stack([
        solve_dispatch(f.bind(member_paths[i]), member_paths[i], times,
                       y0s[i], generator=generators[i], dt=dt, method=method)
        for i, f in enumerate(fields)])


def packed_cde_solve(funcs: Sequence, path, times, z0s: torch.Tensor, *,
                     method: str = "rk4", dt: Optional[float] = None,
                     paths=None, use_fused: bool = True) -> torch.Tensor:
    """K members' CDE solve (ensemble.py:166-205): on CUDA tensors where
    the fused CDE kernels take the field (FinalTanh, SingleHiddenLayer,
    GRUODEField), `fused_cde_solve_packed` (one launch of the member-axis
    CDE kernels for all K), else each member's eager cdeint, as
    `cde_solve_dispatch` chooses for a solo solve. Returns [K, T, B, H]."""
    dt = resolve_dt(times, floor=0.0) if dt is None else dt
    if (use_fused and z0s.device.type == "cuda"
            and supports_fused_cde(funcs[0], method)):
        return fused_cde_solve_packed(list(funcs), path, times, z0s, dt=dt,
                                      method=method, paths=paths)
    member_paths = paths if paths is not None else [path] * len(funcs)
    return torch.stack([cdeint(member_paths[i], f, z0s[i], times, dt=dt,
                               method=method)
                        for i, f in enumerate(funcs)])


def _final(zs, final_index):
    """zs [T, B, H] at each row's final index -> [B, H]."""
    idx = torch.as_tensor(final_index, device=zs.device).long()
    return zs[idx, torch.arange(zs.shape[1], device=zs.device)]


class SeedEnsemble(nn.Module):
    """K seed replicas of a terminal-readout NeuralSDE (ensemble.py:36).

    forward(times, coeffs, final_index, *, generators) -> logits
    [K, B, out]: every member sees the same data and solves with its own
    weights and noise."""

    def __init__(self, make_field: Callable, input_channels: int,
                 hidden_channels: int, output_channels: int, n_members: int,
                 method: str = "euler", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        fields, inits, reads = [], [], []
        for _ in range(n_members):
            fields.append(make_field(generator))
            inits.append(lin(input_channels, hidden_channels))
            reads.append(ReadoutHead(hidden_channels, output_channels,
                                     generator=generator, device=device))
        self.fields = nn.ModuleList(fields)
        self.initial_networks = nn.ModuleList(inits)
        self.readouts = nn.ModuleList(reads)
        self.method = method

    @property
    def n_members(self) -> int:
        return len(self.fields)

    def member(self, k: int) -> nn.ModuleList:
        """Member k's modules (field, initial network, readout)."""
        return nn.ModuleList([self.fields[k], self.initial_networks[k],
                              self.readouts[k]])

    def member_reg(self, k: int) -> nn.Module:
        return self.fields[k]

    def solve(self, times, coeffs, *, generators, dt=None) -> torch.Tensor:
        """The packed solve: zs [K, T, B, H]."""
        path = CubicPath(coeffs, times)
        x0 = path.evaluate(path.times[0])
        y0s = torch.stack([net(x0) for net in self.initial_networks])
        return packed_solve(list(self.fields), path, times, y0s, generators,
                            method=self.method, dt=dt)

    def forward(self, times, coeffs, final_index, *, generators, dt=None):
        zs = self.solve(times, coeffs, generators=generators, dt=dt)
        return torch.stack([
            head(_final(zs[i], final_index), generator=generators[i])
            for i, head in enumerate(self.readouts)])


class IVMember(nn.Module):
    """One seed replica of the sepsis InitialValue model (ensemble.py:208):
    static-feature encoder, DiffusionField and terminal readout."""

    def __init__(self, static_dim: int, hidden_channels: int,
                 output_channels: int, field: nn.Module, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        self.linear1 = lin(static_dim, 256)
        self.linear2 = lin(256, hidden_channels)
        self.field = field
        self.readout = ReadoutHead(hidden_channels, output_channels,
                                   generator=generator, device=device)


class InitialValueSeedEnsemble(nn.Module):
    """K seed replicas of the sepsis flagship model trained through one
    packed solve (ensemble.py:219). The reference trains each of its 5
    repeats in its own process on the same data; repeats differ only in
    their initial weights and training noise, which is what the members'
    weights and generators are here.

    forward(times, coeffs, static, final_index, *, generators) -> logits
    [K, B, out]."""

    def __init__(self, make_field: Callable, static_dim: int,
                 hidden_channels: int, output_channels: int, n_members: int,
                 method: str = "euler", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.members = nn.ModuleList(
            IVMember(static_dim, hidden_channels, output_channels,
                     make_field(generator), generator=generator,
                     device=device)
            for _ in range(n_members))
        self.method = method

    @property
    def n_members(self) -> int:
        return len(self.members)

    def member(self, k: int) -> nn.Module:
        return self.members[k]

    def member_reg(self, k: int) -> nn.Module:
        return self.members[k].field

    def forward(self, times, coeffs, static, final_index, *, generators,
                dt=None):
        y0s = torch.stack([m.linear2(torch.relu(m.linear1(static)))
                           for m in self.members])              # [K, B, H]
        path = CubicPath(coeffs, times)
        zs = packed_solve([m.field for m in self.members], path, times, y0s,
                          generators, method=self.method, dt=dt)
        return torch.stack([
            m.readout(_final(zs[i], final_index), generator=generators[i])
            for i, m in enumerate(self.members)])
