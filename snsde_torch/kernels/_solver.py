"""What the fused solver kernel pairs (fused_em.py, fused_srk.py) share on
the Python side (fused_cde.py and fused_rnn.py use the input checks and the
library), as csrc/sde_hopper.cuh holds what they share on the device: the
modes they take, the input checks, the loaded library with its common C
interface, the sums of the weight gradient's split partials, and the
precomputes outside the kernels (the drift's weights and rows by drift
mode, the diffusion magnitude gk(t) or the noise net's an1 rows and
weights, the stage times).

The modes are the JAX kernels' (snsde/kernels/fused_em.py:_config): the
drift mode by input_option ('xt' 0, 'yy' 1/3/5, 'embm' 2/4/6: the merged
emb drift), the noise mode by noise_option ('precomp' 0-6, 11-13, 16, 17;
'elem' 7-10; 'net1' 14/15; 'net2' 18/19), mult_y and geometric. The
kernels take the whole 7 x 20 grid.

One launch of an SDE pair solves K same-configuration members (a seed
ensemble): the wrappers take a member's tensors with a leading K axis
(y0 [K, B, H], ...), or without it for one solve, which is the K = 1
launch. Every member has its own control streams too (xh, a; the SRK's
xh0, xh1, a0, a1), since they are made from its own weights. Member i of a
launch is bit for bit a launch of member i alone under the same plan.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PRECOMP_NO", "ELEM_NO", "MULT_Y_NO", "DRIFT_BY_IO",
           "DRIFT_CODE", "NOISE_CODE", "LATENT_CODE", "SolverLib",
           "sde_modes", "noise_mode", "supports_fused", "check_supported",
           "check_tensors", "kernel_dims", "wgrad_partial_sizes",
           "precomp_gk", "drift_weights",
           "drift_rows", "noise_rows", "noise_weights", "elem_base",
           "elem_deriv", "stage_times", "SDE_INT_NAMES", "SDE_SHAPE_NAMES",
           "is_net", "mode_codes", "SdeModes", "sde_mode", "check_mode",
           "drift_input", "noise_base", "noise_back",
           "member_count", "member_shapes", "member_args",
           "stack_members", "select_member", "per_member",
           "split_weight_grads", "MATMUL_CODE", "resolve_precision",
           "bf16_round", "mm_op", "one_hot_op",
           "precision_ints", "widen", "widen_output", "precision_counts",
           "count_precision"]

PRECOMP_NO = {0, 1, 2, 3, 4, 5, 6, 11, 12, 13, 16, 17}
ELEM_NO = {7, 8, 9, 10}
MULT_Y_NO = {3, 6, 11, 13, 15, 17, 19}
DRIFT_BY_IO = {0: "xt", 1: "yy", 2: "embm", 3: "yy", 4: "embm", 5: "yy",
               6: "embm"}
# the kernels' codes of the modes (csrc/sde_hopper.cuh: DR_*, NZ_*)
DRIFT_CODE = {"embm": 0, "yy": 1, "xt": 2}
NOISE_CODE = {"precomp": 0, "elem": 1, "net1": 2, "net2": 3}
# the noise code of the EM kernels' latent instances (csrc/fused_em.cu:
# NZ_LAT), which the libraries' plans and launches take in its place
LATENT_CODE = 4


def noise_mode(no: int) -> str:
    """The noise mode of a noise_option."""
    if no in PRECOMP_NO:
        return "precomp"
    if no in ELEM_NO:
        return "elem"
    return "net1" if no in (14, 15) else "net2"


def sde_modes(field) -> dict:
    """The kernels' flags for a field: drift and noise mode, the elem
    option (the noise_option in mode 'elem', else 0), mult_y, geometric."""
    io, no = field.input_option, field.noise_option
    noise = noise_mode(no)
    return {"drift": DRIFT_BY_IO[io], "noise": noise,
            "elem": no if noise == "elem" else 0,
            "mult_y": no in MULT_Y_NO, "geometric": io in (5, 6)}


def supports_fused(field) -> bool:
    """True when the CUDA kernels take the field's configuration: every
    input_option (0-6) x noise_option (0-19) of a DiffusionField, as the
    JAX kernels do (snsde/kernels/fused_em.py:1072-1081)."""
    io = getattr(field, "input_option", None)
    no = getattr(field, "noise_option", None)
    return io in DRIFT_BY_IO and isinstance(no, int) and 0 <= no <= 19


def check_supported(field, label: str) -> None:
    if not supports_fused(field):
        raise ValueError(
            f"{label} kernels take input_option 0-6 and noise_option "
            f"0-19; got ({getattr(field, 'input_option', None)}, "
            f"{getattr(field, 'noise_option', None)})")


def check_tensors(label: str, want: dict, got: dict, device,
                  modes=None, bf16=()) -> None:
    """Raise ValueError unless every tensor of `got` that is not None is
    float32 (bfloat16 for the names in `bf16`), on `device`, contiguous and
    of the shape `want` names; with `modes` (SdeModes), also unless each
    tensor they decide is given exactly when they take it (check_mode, in
    the same pass)."""
    need = modes.need if modes is not None else {}
    for name, t in got.items():
        if name in need and need[name] != (t is not None):
            check_mode(label, modes, **{name: t})
        if t is None:
            continue
        dtype = torch.bfloat16 if name in bf16 else torch.float32
        if t.dtype != dtype:
            raise ValueError(
                f"{label} kernel takes float32 only: {name} is {t.dtype}"
                if name not in bf16 else
                f"{label} kernel takes {name} in bfloat16 with bf16 "
                f"streams: it is {t.dtype}")
        if t.device != device:
            raise ValueError(f"{label} kernel: {name} is on {t.device}, "
                             f"y0 on {device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{label} kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{label} kernel: {name} is not contiguous")


def kernel_dims(label: str, y0, wout, w_inner, dts):
    """(M, B, H, HH, n_inner) from the tensors that fix them (a member's,
    with a leading K axis on each but dts in a packed launch); ValueError
    on the wrong rank. Any width is taken here: the kernels place what does
    not fit shared memory in device memory (`SolverLib.stream` raises where
    even that cannot launch)."""
    k = int(y0.ndim == 3)
    if (y0.ndim not in (2, 3) or wout.ndim != 2 + k or w_inner.ndim != 3 + k
            or dts.ndim != 1):
        raise ValueError(f"{label} kernel: y0 [B,H], wout [HH,H], w_inner "
                         "[n_inner,HH,HH] (each with a leading member axis "
                         "in a packed launch) and dts [M] expected")
    B, H = y0.shape[k:]
    return dts.shape[0], B, H, wout.shape[k], w_inner.shape[k]


def member_count(y0) -> int:
    """K of a packed launch (y0 [K, B, H]); 0 for a solo one (y0 [B, H])."""
    return y0.shape[0] if y0.ndim == 3 else 0


def member_shapes(want: dict, K: int) -> dict:
    """The shapes of a packed launch's tensors: a member's with a leading
    K, but for dts."""
    return {n: s if n == "dts" else (K,) + s for n, s in want.items()}


def member_args(args: dict, k: int) -> dict:
    """Member k's tensors of a packed launch's (by name)."""
    return {n: t if t is None or n == "dts" else t[k]
            for n, t in args.items()}


def stack_members(outs, axes=None):
    """The members' results (each a tensor, None or a NamedTuple of them)
    stacked along each field's member axis (`axes`: field -> axis, 0 where
    not named)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    axes = axes or {}
    return type(first)(*(
        None if getattr(first, f) is None else
        torch.stack([getattr(o, f) for o in outs], axes.get(f, 0))
        for f in first._fields))


def per_member(fn, names, args, K: int, axes=None, **kw):
    """The plain version of a packed launch: fn on each member's tensors
    (args by `names`; a NamedTuple keyword with a member axis its own
    member's, by `axes`), the results stacked."""
    outs = []
    for k in range(K):
        mk = member_args(dict(zip(names, args)), k)
        kwk = {n: select_member(v, k, axes) if isinstance(v, tuple) else v
               for n, v in kw.items()}
        outs.append(fn(*mk.values(), **kwk))
    if isinstance(outs[0], tuple) and not hasattr(outs[0], "_fields"):
        return tuple(stack_members(list(o), axes) for o in zip(*outs))
    return stack_members(outs, axes)


def select_member(nt, k: int, axes=None):
    """Member k's fields of a NamedTuple of a packed launch's tensors."""
    if nt is None:
        return None
    axes = axes or {}
    return type(nt)(*(None if t is None else t.select(axes.get(f, 0), k)
                      for f, t in zip(nt._fields, nt)))


_P = ctypes.c_void_p
_I = ctypes.c_int


class SolverLib:
    """The library of one kernel pair, csrc/<source>.cu (source defaults to
    name), built and loaded at first use (never at construction). Every
    such pair has the same shape of C interface: <name>_fwd and <name>_bwd
    (tensor pointers, null for a tensor given as None, then the ints
    `int_names`, then the stream), <name>_smem_bytes (the ints
    `shape_names`, then 1 for the backward), <name>_max_smem and
    <name>_error_string. `label` names the pair
    in errors. The SDE pairs take SDE_INT_NAMES and size their shared
    memory by SDE_SHAPE_NAMES. A library
    may have further launch entries of the same shape (`launches`: suffix
    -> number of tensor pointers, or (pointers, ints) for an entry that
    takes its own count of ints) and entries that take ints and return an
    int (`int_fns`: suffix -> number of ints; `call`). The SDE and CDE
    pairs have <name>_plan (the ints `shape_names`, 1 for the backward,
    then the field: 0 the placement, 1 batch rows a block; `rows`) and
    <name>_force_placement (`force_placement`). The host-side queries that
    depend only on the shapes are asked once per shape and kept."""

    def __init__(self, name: str, label: str, n_fwd_ptrs: int,
                 n_bwd_ptrs: int, *, int_names, shape_names,
                 source: str = "", launches=None, int_fns=None):
        self.name, self.label = name, label
        self.source = source or name
        self._n_ptrs = {"fwd": n_fwd_ptrs, "bwd": n_bwd_ptrs,
                        **(launches or {})}
        self._int_fns = dict(int_fns or {})
        self.int_names, self.shape_names = tuple(int_names), tuple(shape_names)
        self._kept = {}

    @functools.cached_property
    def _lib(self) -> ctypes.CDLL:
        from ._build import load

        lib = load(self.source)
        fn = lambda suffix: getattr(lib, f"{self.name}_{suffix}")
        for which, n in self._n_ptrs.items():
            n, n_ints = n if isinstance(n, tuple) else (n, len(self.int_names))
            fn(which).argtypes = [_P] * n + [_I] * n_ints + [_P]
            fn(which).restype = _I
        fn("smem_bytes").argtypes = [_I] * (len(self.shape_names) + 1)
        fn("smem_bytes").restype = ctypes.c_longlong
        fn("error_string").argtypes = [_I]
        fn("error_string").restype = ctypes.c_char_p
        fn("max_smem").argtypes = []
        fn("max_smem").restype = _I
        for suffix, n in self._int_fns.items():
            fn(suffix).argtypes = [_I] * n
            fn(suffix).restype = _I
        return lib

    def _fn(self, suffix: str):
        return getattr(self._lib, f"{self.name}_{suffix}")

    def call(self, suffix: str, *ints: int) -> int:
        """<name>_<suffix>(*ints) of an entry named in `int_fns`."""
        return self._fn(suffix)(*(int(v) for v in ints))

    def kept(self, suffix: str, *ints: int) -> int:
        """<name>_<suffix>(*ints), asked once per arguments: for the
        queries that depend only on the shapes (and on the placement a test
        forces)."""
        key = (suffix,) + tuple(int(v) for v in ints)
        if key not in self._kept:
            self._kept[key] = self._fn(suffix)(*key[1:])
        return self._kept[key]

    def rows(self, shape, backward: bool) -> int:
        """Batch rows a block (the CDE pair: a cluster) of a launch at
        `shape` (the ints `shape_names`): the leading dimension of the
        partials is ceil(B / rows)."""
        return self.kept("plan", *shape, int(backward), 1)

    def placement(self, shape, backward: bool) -> int:
        """The level of a launch's plan at `shape`: for the SDE pairs 0 the
        weight slices in shared memory, 1 the weights read from device
        memory (csrc/sde_hopper.cuh: sde_plan); for the CDE pair its plan's
        level (csrc/fused_cde.cu)."""
        return self.kept("plan", *shape, int(backward), 0)

    def force_placement(self, first: int) -> None:
        """Make later launches take level `first` of their plan or a later
        one; 0 restores the host's own choice. For tests of each level."""
        if self.call("force_placement", first) != 0:
            raise ValueError(f"no placement {first}")
        self._kept.clear()

    def stream(self, y0, shape, backward: bool) -> int:
        """The current CUDA stream's handle, after checking that y0 is on
        CUDA (before anything is built) and that the launch's shared memory
        at `shape` (the ints `shape_names`), in the placement its plan
        takes, fits the device: ValueError otherwise."""
        if y0.device.type != "cuda":
            raise ValueError(f"the {self.label} kernels take CUDA tensors; "
                             f"got {y0.device}")
        need = self.kept("smem_bytes", *shape, int(backward))
        limit = self.kept("max_smem")
        if need > limit:
            part = "backward" if backward else "forward"
            dims = ", ".join(f"{n}={v}" for n, v in zip(self.shape_names,
                                                        shape))
            raise ValueError(
                f"{self.label} {part} kernel: {dims} needs {need} bytes of "
                f"shared memory a block even with the weights and gradient "
                f"accumulators in device memory and its fewest rows, above "
                f"this device's {limit}-byte limit per block")
        return torch.cuda.current_stream(y0.device).cuda_stream

    def launch(self, which: str, tensors, ints, stream: int) -> None:
        """Run <name>_<which> ('fwd', 'bwd' or an entry of `launches`) on
        the tensors' pointers and its ints (`int_names`); RuntimeError with
        the CUDA error if the launch fails."""
        err = self._fn(which)(*(None if t is None else t.data_ptr()
                                for t in tensors),
                              *(int(v) for v in ints), stream)
        if err != 0:
            msg = self._fn("error_string")(err).decode()
            part = {"fwd": "forward", "bwd": "backward"}.get(which, which)
            raise RuntimeError(f"{self.label} {part} kernel launch failed: "
                               f"{msg}")


def _n_nets(noise: str) -> int:
    return {"net1": 1, "net2": 2}.get(noise, 0)


def wgrad_partial_sizes(S: int, H: int, HH: int, n_inner: int,
                        drift: str = "embm", noise: str = "precomp"):
    """Floats of each weight's split partials in an SDE weight-gradient
    kernel's scratch a member, in its order: Wy' [S, H+1, HH] (not in drift
    mode 'xt'), each W_l [S, HH+1, HH], Wout [S, HH+1, H], then the noise
    net's Wn1 and (net2) Wn2 [S, H+1, H] (the last row of each the bias
    sum); with S = 1 those of the summed output."""
    return ([S * (H + 1) * HH] * (drift != "xt")
            + [S * (HH + 1) * HH] * n_inner + [S * (HH + 1) * H]
            + [S * (H + 1) * H] * _n_nets(noise))


def split_weight_grads(w: torch.Tensor, H: int, HH: int, n_inner: int,
                       drift: str = "embm", noise: str = "precomp"):
    """The weight gradient from an SDE weight-gradient launch's summed
    output w [..., n] (wgrad_partial_sizes with S = 1, after any leading
    member axis; the library sums each weight's split partials in a fixed
    order): (dWy', dW_inner, db_inner, dWout, dbo), each with w's leading
    axes, dWy' None in drift mode 'xt'; with a noise net also (dWn1, dWn2,
    dbn2), None where the net has no such weight. Views and one stack."""
    lead = tuple(w.shape[:-1])
    parts = list(torch.split(w, wgrad_partial_sizes(1, H, HH, n_inner, drift,
                                                    noise), dim=-1))
    nn = _n_nets(noise)
    nets = [t.reshape(*lead, H + 1, H) for t in parts[len(parts) - nn:]]
    parts = parts[:len(parts) - nn]
    wy_ = parts.pop(0).reshape(*lead, H + 1, HH) if drift != "xt" else None
    wo_ = parts.pop().reshape(*lead, HH + 1, H)
    if parts:
        inner = torch.stack([t.reshape(*lead, HH + 1, HH) for t in parts],
                            dim=len(lead))
        dwi, dbi = inner[..., :HH, :], inner[..., HH, :]
    else:
        dwi, dbi = (w.new_empty(lead + (0, HH, HH)),
                    w.new_empty(lead + (0, HH)))
    out = (None if wy_ is None else wy_[..., :H, :], dwi, dbi,
           wo_[..., :HH, :], wo_[..., HH, :])
    if not nn:
        return out
    return out + (nets[0][..., :H, :],
                  nets[1][..., :H, :] if nn > 1 else None,
                  nets[1][..., H, :] if nn > 1 else None)


# ---------------------------------------------------------------------------
# The precomputes outside the kernels (differentiable through autograd)
# ---------------------------------------------------------------------------

def precomp_gk(field, t_lo: torch.Tensor) -> torch.Tensor:
    """Diffusion magnitude gk(t) [M, H] of the t-only noise families
    (`snsde/kernels/fused_em.py:131-157`); mult_y is applied in-kernel."""
    no = field.noise_option
    M, H = t_lo.shape[0], field.hidden_channels
    tcol = t_lo[:, None]
    tf = torch.stack([torch.sin(t_lo), torch.cos(t_lo)], dim=-1)
    if no == 0:
        return torch.zeros((M, H), dtype=t_lo.dtype, device=t_lo.device)
    if no in (1, 2, 3):
        gk = torch.exp(field.sigma).expand(M, H)
        return gk * tcol if no == 2 else gk
    if no in (4, 5, 6):
        gk = torch.exp(field.sigma_diag).expand(M, H)
        return gk * tcol if no == 5 else gk
    if no == 11:
        return tcol.expand(M, H)
    if no in (12, 13):
        return field.noise_t(tf)
    return torch.relu(field.noise_t(tf))           # 16, 17


def drift_weights(field, device) -> dict:
    """The drift's weights in [in, out] layout: the first layer's y-part wy
    (drift mode 'embm': the merged Wy' = Wy We1; 'yy': linear_in's
    y-columns; 'xt': None) and the MLP's stacked inner layers and output
    layer (differentiable)."""
    H, io = field.hidden_channels, field.input_option
    drift = DRIFT_BY_IO[io]
    w_in = field.linear_in.weight                 # [HH, 2 + H] or [HH, H]
    HH = w_in.shape[0]
    if drift == "xt":
        wy = None
    else:
        wy = w_in[:, 2:].t() if io in (3, 4, 5, 6) else w_in.t()
        if drift == "embm":
            wy = wy @ field.emb.weight[:, :H].t()     # Wy We1, [in, out]
        wy = wy.contiguous()
    if len(field.linears):
        w_inner = torch.stack([l.weight.t() for l in field.linears])
        b_inner = torch.stack([l.bias for l in field.linears])
    else:
        w_inner = torch.zeros((0, HH, HH), dtype=torch.float32, device=device)
        b_inner = torch.zeros((0, HH), dtype=torch.float32, device=device)
    return {"wy": wy, "w_inner": w_inner, "b_inner": b_inner,
            "wout": field.linear_out.weight.t().contiguous(),
            "bo": field.linear_out.bias}


def drift_rows(field, path, tv: np.ndarray, t: torch.Tensor):
    """The y-independent parts of the drift input at stage times tv [M]
    (host float64; `t` is the same times as a float32 tensor on the
    device), (xh [M, B, HH], a [M, HH]), differentiable, by drift mode:
    'embm' the hoist xh' = (X(t) W_init + b_init) We2 (one [M*B, C]
    product) and a' = (tf Wt + b_in) We1 + be; 'yy' no xh and a = tf Wt +
    b_in (b_in alone for input_option 1); 'xt' xh = X(t) W_init + b_init and
    no a (snsde/kernels/fused_em.py:1226-1258)."""
    H, io = field.hidden_channels, field.input_option
    drift = DRIFT_BY_IO[io]
    xh = a = None
    if drift != "yy":
        xh = field.initial_network(path.evaluate_grid(tv))
        if drift == "embm":
            xh = xh @ field.emb.weight[:, H:].t()     # @ We2 [in, out]
        xh = xh.contiguous()
    if drift != "xt":
        w_in = field.linear_in.weight
        if io in (3, 4, 5, 6):
            tf = torch.stack([torch.sin(t), torch.cos(t)], dim=-1)  # [M, 2]
            a = tf @ w_in[:, :2].t() + field.linear_in.bias
        else:
            a = field.linear_in.bias.expand(len(tv), -1)
        if drift == "embm":
            a = a @ field.emb.weight[:, :H].t() + field.emb.bias
        a = a.contiguous()
    return xh, a


def _noise_first(field):
    """The noise net's first layer (noise_y, or its first module)."""
    ny = field.noise_y
    return ny[0] if isinstance(ny, torch.nn.Sequential) else ny


def noise_rows(field, t: torch.Tensor):
    """The row stream of the diffusion at stage times t [M]: gk(t) [M, H]
    in mode 'precomp', an1 = tf Wn1_t + bn1 [M, H] in the nets' modes
    (snsde/kernels/fused_em.py:1283-1289), None in mode 'elem'
    (differentiable)."""
    noise = noise_mode(field.noise_option)
    if noise == "precomp":
        return precomp_gk(field, t).contiguous()
    if noise == "elem":
        return None
    n1 = _noise_first(field)
    tf = torch.stack([torch.sin(t), torch.cos(t)], dim=-1)      # [M, 2]
    return (tf @ n1.weight[:, :2].t() + n1.bias).contiguous()


def noise_weights(field) -> dict:
    """The noise net's weights in [in, out] layout: wn1 (its first layer's
    y-columns), wn2 and bn2 (net2's second layer); None where the mode has
    no such weight (differentiable)."""
    noise = noise_mode(field.noise_option)
    out = {"wn1": None, "wn2": None, "bn2": None}
    if noise in ("net1", "net2"):
        out["wn1"] = _noise_first(field).weight[:, 2:].t().contiguous()
    if noise == "net2":
        out["wn2"] = field.noise_y[2].weight.t().contiguous()
        out["bn2"] = field.noise_y[2].bias
    return out


def elem_base(no: int, y: torch.Tensor) -> torch.Tensor:
    """The elementwise noise base of noise_option 7-10 as the JAX kernel
    takes it (snsde/kernels/fused_em.py:381-392): sqrt is 0 where y <= 0
    (the reference's nan_to_num)."""
    if no == 7:    # the inner where keeps sqrt's gradient finite at y <= 0
        return torch.where(y > 0, torch.sqrt(torch.where(y > 0, y, 1.0)),
                           torch.zeros_like(y))
    if no == 8:
        return y * y * y
    if no == 9:
        return torch.sigmoid(y)
    return torch.clamp(y, min=0.0)


def elem_deriv(no: int, y: torch.Tensor) -> torch.Tensor:
    """Its derivative as the JAX kernel takes it (:424-437): sqrt's is 0
    where y <= 0."""
    if no == 7:
        return torch.where(y > 0, 0.5 * torch.rsqrt(torch.clamp(y, min=1e-30)),
                           torch.zeros_like(y))
    if no == 8:
        return 3.0 * y * y
    if no == 9:
        s = torch.sigmoid(y)
        return s * (1.0 - s)
    return (y > 0).to(y.dtype)


def stage_times(device, *tvs: np.ndarray) -> torch.Tensor:
    """Host stage-time vectors [M] as rows of one float32 tensor on the
    device: one host-to-device copy (each copy from pageable host memory
    waits for the stream)."""
    return torch.as_tensor(np.stack(tvs), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# The modes as the pairs' wrappers and plain versions take them
# ---------------------------------------------------------------------------

# the SDE libraries' ints of a launch, and of the shape their plans and
# shared memory depend on
SDE_INT_NAMES = ("M", "B", "H", "HH", "n_inner", "mult_y", "geometric",
                 "drift", "noise", "elem", "members")
SDE_SHAPE_NAMES = ("B", "H", "HH", "n_inner", "drift", "noise", "members")


def is_net(noise: str) -> bool:
    return noise in ("net1", "net2")


def mode_codes(drift: str, noise: str):
    return DRIFT_CODE[drift], NOISE_CODE[noise]


class SdeModes(NamedTuple):
    """A launch's modes as the kernels and the plain versions take them:
    `flags` the plain versions' keywords (mult_y, geometric, drift, noise,
    elem), `ints` SDE_INT_NAMES's five modes, `codes` (drift, noise) as
    the plans take them (the latent mode's noise code LATENT_CODE), `need`:
    for each tensor the modes decide (a stage's xh0, a1, gk2 ... by its own
    name too; the latent rows `lat`), whether they take it, and `latent`:
    the EM pair's latent mode (the plain versions' `latent` keyword)."""
    flags: dict
    ints: tuple
    codes: tuple
    need: dict
    latent: bool = False


@functools.lru_cache(maxsize=None)
def sde_mode(mult_y, geometric, drift, noise, elem,
             latent: bool = False) -> SdeModes:
    """The SdeModes of a launch, made once per distinct modes; ValueError
    on a mode the kernels do not know, and on a latent mode other than the
    JAX kernel's one (snsde/kernels/fused_em.py:1385-1386): drift 'yy' with
    noise 'precomp', without mult_y and geometric. Treat the result as
    read-only."""
    if drift not in DRIFT_CODE or noise not in NOISE_CODE:
        raise ValueError(f"fused SDE kernels: no mode ({drift}, {noise})")
    if noise == "elem" and elem not in (7, 8, 9, 10):
        raise ValueError(f"fused SDE kernels: elem option {elem} is not 7-10")
    if latent and (drift, noise, bool(mult_y), bool(geometric)) != (
            "yy", "precomp", False, False):
        raise ValueError(
            f"fused SDE kernels: the latent mode takes drift 'yy' and noise "
            f"'precomp' without mult_y and geometric; got ({drift}, {noise}"
            f", mult_y={bool(mult_y)}, geometric={bool(geometric)})")
    need = {"xh": drift != "yy", "a": drift != "xt", "wy": drift != "xt",
            "gk": noise != "elem", "wn1": is_net(noise),
            "wn2": noise == "net2", "bn2": noise == "net2",
            "lat": bool(latent)}
    need.update({f"{k}{i}": need[k] for k, n in (("xh", 2), ("a", 2),
                                                  ("gk", 3))
                 for i in range(n)})
    codes = mode_codes(drift, noise)
    if latent:
        codes = (codes[0], LATENT_CODE)
    return SdeModes({"mult_y": bool(mult_y), "geometric": bool(geometric),
                     "drift": drift, "noise": noise, "elem": int(elem)},
                    (int(bool(mult_y)), int(bool(geometric)), *codes,
                     int(elem)), codes, need, bool(latent))


# ---------------------------------------------------------------------------
# Precision: the stream dtype and the operand mode of the in-kernel products
# ---------------------------------------------------------------------------

# the operand modes of the in-kernel products (the JAX package's
# SNSDE_FUSED_MATMUL, snsde/kernels/fused_em.py:_dot :67-107) and their codes
# in the kernels' libraries (csrc/operand_modes.cuh: MM_F32, MM_X3,
# MM_BF16)
MATMUL_CODE = {"f32": 0, "bf16x3": 1, "bf16": 2}


def resolve_precision(stream_dtype=None, matmul=None):
    """(stream dtype, operand mode) of a fused solve. None resolves from the
    environment as the JAX entries resolve it (fused_em.py:1113-1118 and
    _mm_mode :110-115): SNSDE_FUSED_STREAM=bf16 gives torch.bfloat16,
    anything else float32; SNSDE_FUSED_MATMUL=bf16 gives 'bf16', bf16x3
    'bf16x3', anything else 'f32' (exact). ValueError on another explicit
    value."""
    if stream_dtype is None:
        stream_dtype = (torch.bfloat16
                        if os.environ.get("SNSDE_FUSED_STREAM", "f32")
                        == "bf16" else torch.float32)
    if stream_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused solve: stream_dtype {stream_dtype} is not "
                         f"torch.float32 or torch.bfloat16")
    if matmul is None:
        v = os.environ.get("SNSDE_FUSED_MATMUL", "f32")
        matmul = v if v in ("bf16", "bf16x3") else "f32"
    if matmul not in MATMUL_CODE:
        raise ValueError(f"fused solve: matmul {matmul!r} is not one of "
                         f"{sorted(MATMUL_CODE)}")
    return stream_dtype, matmul


def precision_ints(label: str, stream: str, matmul: str) -> tuple:
    """A launch's ints of its precision: (operand mode, stream flag: 1 for
    bf16 streams); ValueError on an unknown one."""
    if stream not in ("f32", "bf16") or matmul not in MATMUL_CODE:
        raise ValueError(f"{label}: no precision (stream {stream!r}, "
                         f"matmul {matmul!r})")
    return MATMUL_CODE[matmul], int(stream == "bf16")


def widen(t, like):
    """A stream (bf16 when the stream dtype is) in like's dtype."""
    return None if t is None else t.to(like.dtype)


def widen_output(y0: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """[y0, ys] in y0's dtype: with bf16 streams y0 rounded as the
    trajectory is (snsde/kernels/fused_em.py:1338, fused_srk.py:841,
    fused_cde.py:753)."""
    return torch.cat([y0[None].to(ys.dtype), ys], dim=0).to(y0.dtype)


def precision_counts(kernels) -> dict:
    """A launch count for each of `kernels` in each reduced precision,
    keyed "<kernel> <operand mode> <stream dtype>"."""
    return {f"{k} {m} {st}": 0 for k in kernels for m in MATMUL_CODE
            for st in ("f32", "bf16") if (m, st) != ("f32", "f32")}


def count_precision(counts: dict, kernel: str, stream: str,
                    matmul: str) -> None:
    """One more launch of `kernel` in a reduced precision (none counted in
    exact fp32)."""
    key = f"{kernel} {matmul} {stream}"
    if key in counts:
        counts[key] += 1


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest, ties to even) in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def mm_op(x: torch.Tensor, w: torch.Tensor, matmul: str = "f32"):
    """x @ w as the kernels form an in-kernel product in operand mode
    `matmul` (JAX's _dot, fused_em.py:67-107), accumulating in x's dtype:
    'f32' exact; 'bf16' both operands rounded to bf16 once; 'bf16x3' both
    split into hi = bf16(v) and lo = bf16(v - hi), xh wh + xh wl + xl wh."""
    if matmul == "f32":
        return x @ w
    xh, wh = bf16_round(x), bf16_round(w)
    if matmul == "bf16":
        return xh @ wh
    xl, wl = bf16_round(x - xh), bf16_round(w - wh)
    return xh @ wh + xh @ wl + xl @ wh


def one_hot_op(v: torch.Tensor, matmul: str = "f32"):
    """v through a product with a one-hot factor in operand mode `matmul`
    (the latent KL lane's klm, fused_em.py:352, :472): v; bf16(v); or
    bf16(v) + bf16(v - bf16(v))."""
    if matmul == "f32":
        return v
    h = bf16_round(v)
    return h if matmul == "bf16" else h + bf16_round(v - h)


def check_mode(label: str, modes: SdeModes, **tensors) -> None:
    """Raise ValueError when a tensor the modes decide (by name) is not
    theirs: one they need is None, or one they do not take is given."""
    need = modes.need
    for name, t in tensors.items():
        if name in need and need[name] != (t is not None):
            raise ValueError(
                f"{label} ({modes.flags['drift']}, {modes.flags['noise']}"
                f"{', latent' if modes.latent else ''}): "
                f"{name} {'missing' if need[name] else 'not taken'}")


def drift_input(y, u, xh, a, wy, drift, matmul="f32"):
    """h_0's input at step u by drift mode (its product in operand mode
    `matmul`)."""
    if drift == "xt":
        return xh[u]
    z = mm_op(y, wy, matmul) + a[u]
    return z + xh[u] if drift == "embm" else z


def noise_base(y, row, noise, elem, wn1, wn2, bn2, relu, matmul="f32"):
    """The diffusion's base at state y (row: the step's gk or an1 row) and,
    for net2, the net's hidden activations."""
    if noise == "precomp":
        return row.expand_as(y), None
    if noise == "elem":
        return elem_base(elem, y), None
    zn1 = mm_op(y, wn1, matmul) + row
    if noise == "net1":
        return zn1, None
    hn = relu(zn1)
    return relu(mm_op(hn, wn2, matmul) + bn2), hn


def noise_back(dbase, y, base, hn, noise, elem, wn1, wn2, matmul="f32"):
    """Back through the base given its cotangent: (y's cotangent through
    the base, dn: the cotangent of the net's first layer's output, dz2: of
    net2's second layer's output)."""
    if noise == "precomp":
        return torch.zeros_like(y), None, None
    if noise == "elem":
        return dbase * elem_deriv(elem, y), None, None
    if noise == "net1":
        return mm_op(dbase, wn1.T, matmul), dbase, None
    dz2 = dbase * (base > 0)
    dn = mm_op(dz2, wn2.T, matmul) * (hn > 0)
    return mm_op(dn, wn1.T, matmul), dn, dz2
