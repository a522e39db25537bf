"""Seed-packed fused solves: K same-configuration members in one launch
(counterpart of snsde/kernels/multi.py:84-553 and :715-748).

The JAX package packs K members into the TPU's 128-lane axis with
block-diagonal weights (`pack_fields`, multi.py:98): a trick of the MXU,
which on a GPU would multiply every product's work by K. Here the EM, SRK
and CDE kernels have a member axis instead (csrc/sde_hopper.cuh,
csrc/fused_cde.cu): one launch runs K members side by side, each with its
own weights, initial state and Brownian or control streams, on the grid's
second dimension. The JAX contract is kept: packed member i is a solo
solve with the same noise, bit for bit under the same plan (its increments
drawn from its own generator exactly as `fused_em_solve`/
`fused_srk_solve`/`fused_latent_em_solve` draw them).

Each member's precomputes (the drift's hoist and rows, the diffusion rows,
its weights in [in, out] layout) are the solo solve's, by the same
operations, stacked on a leading member axis; `paths` gives each member
its own control path (the robustness sweep's seeds each carry their own
missingness), else all members read `path`.

The CDE members (FinalTanh, SingleHiddenLayer, GRU-ODE) stack their
`fused_cde_inputs`, one control-derivative stream each; the LatentSDE
members stack their `latent_inputs` onto the EM pair's latent instances.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.brownian import brownian_increments, space_time_levy_area
from ..ops.solve import make_grid
from .fused_cde import FusedCDE, fused_cde_inputs
from .fused_cde import precision_inputs as cde_precision_inputs
from .fused_cde import _ARG_ORDER as _CDE_ARGS
from .fused_em import (FusedEM, fused_em_inputs, latent_inputs,
                       precision_inputs, solve_modes)
from .fused_em import _ARG_ORDER as _EM_ARGS
from .fused_srk import FusedSRK, fused_srk_inputs
from .fused_srk import _ARG_ORDER as _SRK_ARGS
from .fused_srk import precision_inputs as srk_precision_inputs
from .fused_srk import solve_modes as srk_solve_modes

__all__ = ["fused_em_solve_packed", "fused_srk_solve_packed",
           "fused_cde_solve_packed", "fused_latent_em_solve_packed",
           "check_same_config"]


def check_same_config(fields) -> None:
    """ValueError unless every member has the first one's configuration:
    input and noise option, widths and depth (multi.py:84)."""
    f0 = fields[0]
    for f in fields[1:]:
        if (f.input_option != f0.input_option
                or f.noise_option != f0.noise_option
                or f.linear_out.out_features != f0.linear_out.out_features
                or f.linear_out.in_features != f0.linear_out.in_features
                or len(f.linears) != len(f0.linears)):
            raise ValueError(
                "pack_fields needs identically-configured models "
                "(same input/noise option, widths, depth)")


def _check_same_shapes(members, label: str) -> None:
    """ValueError unless every member is of the first one's type with
    parameters of the same shapes (the same kind, widths and depth)."""
    shapes = lambda m: (type(m), tuple(p.shape for p in m.parameters()))
    if any(shapes(m) != shapes(members[0]) for m in members[1:]):
        raise ValueError(f"{label} needs identically-configured members "
                         f"(same kind, widths, depth)")


def _member_paths(path, paths, K: int):
    if paths is None:
        return [path] * K
    if len(paths) != K:
        raise ValueError("need one control path per field")
    return list(paths)


def _stack_inputs(inputs: List[dict], order) -> tuple:
    """The members' kernel inputs stacked on a leading axis (dts, the
    grid's, once)."""
    out = []
    for name in order:
        first = inputs[0][name]
        if first is None or name == "dts":
            out.append(first)
        else:
            out.append(torch.stack([i[name] for i in inputs]))
    return tuple(out)


def _setup(fields, times, y0s, dt, K_arg):
    from ..models.neuralsde import resolve_dt

    K = len(fields)
    if y0s.shape[0] != K or len(K_arg) != K:
        raise ValueError("need one y0 slice and one generator (or noise "
                         "draw) per field")
    check_same_config(fields)
    dt = resolve_dt(times) if dt is None else dt
    return K, make_grid(times, dt)


def _out(y0s, ys, out_idx):
    """[y0, ys] of each member in y0s's dtype (a bf16 trajectory widened,
    y0 rounded as it is) on the output times."""
    full = torch.cat([y0s[:, None].to(ys.dtype), ys], dim=1).to(y0s.dtype)
    return full[:, torch.as_tensor(out_idx, device=y0s.device)]


def fused_em_solve_packed(fields: Sequence, path, times, y0s: torch.Tensor,
                          dWs_or_generators, dt: Optional[float] = None,
                          paths=None, stream_dtype=None,
                          matmul=None) -> torch.Tensor:
    """Solve K identically-configured DiffusionFields in one launch of the
    EM kernels (multi.py:240-285). y0s [K, B, H]; dWs_or_generators: K
    torch.Generators (member i draws the dW fused_em_solve(fields[i], ...,
    generator=generators[i]) would) or the increments [K, M, B, H];
    `paths` one control path per member; `stream_dtype` and `matmul` as
    fused_em_solve's. Returns ys [K, T, B, H]."""
    K, (grid, out_idx) = _setup(fields, times, y0s, dt, dWs_or_generators)
    B, H = y0s.shape[1], fields[0].hidden_channels
    member_paths = _member_paths(path, paths, K)
    inputs = []
    for k in range(K):
        dW = dWs_or_generators[k]
        if not isinstance(dW, torch.Tensor):
            dW = brownian_increments(dW, grid, (B, H), torch.float32,
                                     y0s.device)
        inputs.append(precision_inputs(
            fused_em_inputs(fields[k].bind(member_paths[k]),
                            member_paths[k], grid, y0s[k], dW),
            stream_dtype, matmul))
    ys = FusedEM.apply(solve_modes(inputs[0]),
                       *_stack_inputs(inputs, _EM_ARGS))
    return _out(y0s, ys, out_idx)


def fused_srk_solve_packed(fields: Sequence, path, times, y0s: torch.Tensor,
                           dWs_or_generators, dt: Optional[float] = None,
                           paths=None, stream_dtype=None,
                           matmul=None) -> torch.Tensor:
    """The SRIW1 counterpart of fused_em_solve_packed (multi.py:394-444):
    member i's (dW, I10) drawn from its generator as fused_srk_solve
    draws them (dW, then the Lévy area), or given as a pair of [K, M, B, H]
    tensors; `stream_dtype` and `matmul` as fused_srk_solve's. Returns ys
    [K, T, B, H]; member i is fused_srk_solve(fields[i], ...) bit for bit
    under the same plan, in every precision."""
    noise = dWs_or_generators
    if isinstance(noise, tuple) and len(noise) == 2 and isinstance(
            noise[0], torch.Tensor):
        noise = list(zip(noise[0], noise[1]))
    K, (grid, out_idx) = _setup(fields, times, y0s, dt, noise)
    B, H = y0s.shape[1], fields[0].hidden_channels
    member_paths = _member_paths(path, paths, K)
    inputs = []
    for k in range(K):
        if isinstance(noise[k], torch.Generator):
            dW = brownian_increments(noise[k], grid, (B, H), torch.float32,
                                     y0s.device)
            I10 = space_time_levy_area(noise[k], grid, (B, H), dW)
        else:
            dW, I10 = noise[k]
        inputs.append(srk_precision_inputs(
            fused_srk_inputs(fields[k].bind(member_paths[k]),
                             member_paths[k], grid, y0s[k], dW, I10),
            stream_dtype, matmul))
    ys = FusedSRK.apply(srk_solve_modes(inputs[0]),
                        *_stack_inputs(inputs, _SRK_ARGS))
    return _out(y0s, ys, out_idx)


def fused_cde_solve_packed(funcs: Sequence, path, times, z0s: torch.Tensor,
                           dt: Optional[float] = None, method: str = "rk4",
                           paths=None, stream_dtype=None,
                           matmul=None) -> torch.Tensor:
    """Solve K identically-configured CDE fields (FinalTanh,
    SingleHiddenLayer or GRUODEField) in one launch of the CDE kernels
    (multi.py:505-553): z0s [K, B, H]; `paths` one control path per member
    (the robustness sweep's seeds each carry their own missingness), else
    every member reads `path`; `stream_dtype` and `matmul` as
    fused_cde_solve's. Member i is fused_cde_solve(funcs[i], ...) bit for
    bit under the same plan, in every precision. Returns zs [K, T, B, H]."""
    from ..models.neuralsde import resolve_dt

    K = len(funcs)
    if z0s.shape[0] != K:
        raise ValueError("need one z0 slice per field")
    _check_same_shapes(funcs, "fused_cde_solve_packed")
    member_paths = _member_paths(path, paths, K)
    dt = resolve_dt(times, floor=0.0) if dt is None else dt
    grid, out_idx = make_grid(times, dt)
    inputs = [cde_precision_inputs(
        fused_cde_inputs(funcs[k], member_paths[k], grid, z0s[k], method),
        stream_dtype, matmul) for k in range(K)]
    ys = FusedCDE.apply(*_stack_inputs(inputs, _CDE_ARGS), method,
                        inputs[0]["act"], inputs[0]["prec"])
    return _out(z0s, ys, out_idx)


def fused_latent_em_solve_packed(models: Sequence, times,
                                 aug0s: torch.Tensor, dWs_or_generators,
                                 dt: Optional[float] = None,
                                 stream_dtype=None,
                                 matmul=None) -> torch.Tensor:
    """Solve K identically-configured LatentSDE augmented systems in one
    launch of the EM kernels' latent instances (multi.py:715-748, which
    lane-packs them): aug0s [K, B, H] (each member's latent state and a zero
    KL lane); dWs_or_generators: K torch.Generators (member i draws the
    increments fused_latent_em_solve(models[i], ..., generator=
    generators[i]) draws) or the increments [K, M, B, H]; `stream_dtype`
    and `matmul` as fused_latent_em_solve's. Returns ys [K, T, B, H]
    (member i's KL total at ys[i, -1, :, H-1])."""
    from ..models.neuralsde import resolve_dt

    K = len(models)
    if aug0s.shape[0] != K or len(dWs_or_generators) != K:
        raise ValueError("need one aug0 slice and one generator (or noise "
                         "draw) per model")
    _check_same_shapes(models, "fused_latent_em_solve_packed")
    dt = resolve_dt(times) if dt is None else dt
    grid, out_idx = make_grid(times, dt)
    inputs = []
    for k in range(K):
        dW = dWs_or_generators[k]
        if not isinstance(dW, torch.Tensor):
            dW = brownian_increments(dW, grid, tuple(aug0s.shape[1:]),
                                     aug0s.dtype, aug0s.device)
        inputs.append(precision_inputs(
            latent_inputs(models[k], grid, aug0s[k], dW), stream_dtype,
            matmul))
    ys = FusedEM.apply(solve_modes(inputs[0], latent=True),
                       *_stack_inputs(inputs, _EM_ARGS))
    return _out(aug0s, ys, out_idx)
