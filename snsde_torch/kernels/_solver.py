"""What the fused solver kernel pairs (fused_em.py, fused_srk.py) share on
the Python side (fused_cde.py and fused_rnn.py use the input checks and the
library), as csrc/sde_hopper.cuh holds what they share on the device: the
modes they take, the input checks, the loaded library with its common C
interface, the sums of the weight gradient's split partials, and the
precomputes outside the kernels (the merged drift's weights and rows, the
diffusion magnitude gk(t), the stage times).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = ["EMB_IO", "PRECOMP_NO", "MULT_Y_NO", "SolverLib",
           "supports_fused", "check_supported", "check_tensors",
           "kernel_dims", "wgrad_partial_sizes", "sum_wgrad_partials",
           "precomp_gk", "merged_drift_weights", "merged_drift_rows",
           "stage_times"]

EMB_IO = {2, 4, 6}
PRECOMP_NO = {0, 1, 2, 3, 4, 5, 6, 11, 12, 13, 16, 17}
MULT_Y_NO = {3, 6, 11, 13, 15, 17, 19}


def supports_fused(field) -> bool:
    """True when the CUDA kernels take the field's configuration: drift
    mode 'embm' (input_option 2, 4, 6) with a t-only ('precomp')
    diffusion."""
    io = getattr(field, "input_option", None)
    no = getattr(field, "noise_option", None)
    return io in EMB_IO and no in PRECOMP_NO


def check_supported(field, label: str) -> None:
    if not supports_fused(field):
        raise ValueError(
            f"{label} kernels take input_option in {sorted(EMB_IO)} with "
            f"noise_option in {sorted(PRECOMP_NO)}; got "
            f"({getattr(field, 'input_option', None)}, "
            f"{getattr(field, 'noise_option', None)})")


def check_tensors(label: str, want: dict, got: dict, device) -> None:
    """Raise ValueError unless every tensor of `got` that is not None is
    float32, on `device`, contiguous and of the shape `want` names."""
    for name, t in got.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{label} kernel takes float32 only: {name} "
                             f"is {t.dtype}")
        if t.device != device:
            raise ValueError(f"{label} kernel: {name} is on {t.device}, "
                             f"y0 on {device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{label} kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{label} kernel: {name} is not contiguous")


def kernel_dims(label: str, y0, wy, w_inner, dts):
    """(M, B, H, HH, n_inner) from the tensors that fix them; ValueError on
    the wrong rank. Any width is taken here: the kernels place what does
    not fit shared memory in device memory (`SolverLib.stream` raises where
    even that cannot launch)."""
    if y0.ndim != 2 or wy.ndim != 2 or w_inner.ndim != 3 or dts.ndim != 1:
        raise ValueError(f"{label} kernel: y0 [B,H], wy [H,HH], w_inner "
                         "[n_inner,HH,HH] and dts [M] expected")
    B, H = y0.shape
    HH = wy.shape[1]
    return dts.shape[0], B, H, HH, w_inner.shape[0]


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
    in errors. The SDE pairs take (M, B, H, HH, n_inner, mult_y,
    geometric) and size their shared memory by (H, HH, n_inner). A library
    may have further launch entries of the same shape (`launches`: suffix
    -> number of tensor pointers) and entries that take ints and return an
    int (`int_fns`: suffix -> number of ints; `call`). The SDE and CDE
    pairs have <name>_plan (the ints `shape_names`, 1 for the backward,
    then the field: 0 the placement, 1 batch rows a block; `rows`) and
    <name>_force_placement (`force_placement`). The host-side queries that
    depend only on the shapes are asked once per shape and kept."""

    def __init__(self, name: str, label: str, n_fwd_ptrs: int,
                 n_bwd_ptrs: int,
                 int_names=("M", "B", "H", "HH", "n_inner", "mult_y",
                            "geometric"),
                 shape_names=("H", "HH", "n_inner"), source: str = "",
                 launches=None, int_fns=None):
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
            fn(which).argtypes = [_P] * n + [_I] * len(self.int_names) + [_P]
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
        the tensors' pointers and the ints `int_names`; RuntimeError with
        the CUDA error if the launch fails."""
        err = self._fn(which)(*(None if t is None else t.data_ptr()
                                for t in tensors),
                              *(int(v) for v in ints), stream)
        if err != 0:
            msg = self._fn("error_string")(err).decode()
            part = {"fwd": "forward", "bwd": "backward"}.get(which, which)
            raise RuntimeError(f"{self.label} {part} kernel launch failed: "
                               f"{msg}")


def wgrad_partial_sizes(S: int, H: int, HH: int, n_inner: int):
    """Floats of each weight's split partials in an SDE weight-gradient
    kernel's output, in its order: Wy' [S, H+1, HH], each W_l
    [S, HH+1, HH], Wout [S, HH+1, H] (the last row of each the bias sum)."""
    return [S * (H + 1) * HH] + [S * (HH + 1) * HH] * n_inner + [
        S * (HH + 1) * H]


def sum_wgrad_partials(p: torch.Tensor, S: int, H: int, HH: int,
                       n_inner: int):
    """The weight gradient from an SDE weight-gradient kernel's split
    partials p (wgrad_partial_sizes), each weight's S splits summed in a
    fixed order: (dWy', dW_inner, db_inner, dWout, dbo)."""
    sizes = wgrad_partial_sizes(S, H, HH, n_inner)
    parts = [t.reshape(S, -1).sum(0) for t in torch.split(p, sizes)]
    wy_ = parts[0].reshape(H + 1, HH)
    inner = [t.reshape(HH + 1, HH) for t in parts[1:-1]]
    wo_ = parts[-1].reshape(HH + 1, H)
    dwi = (torch.stack([t[:HH] for t in inner]) if inner
           else p.new_empty((0, HH, HH)))
    dbi = (torch.stack([t[HH] for t in inner]) if inner
           else p.new_empty((0, HH)))
    return wy_[:H], dwi, dbi, wo_[:HH], wo_[HH]


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


def merged_drift_weights(field, device) -> dict:
    """The merged drift's weights in [in, out] layout: Wy' = Wy We1 and the
    MLP's stacked inner layers and output layer (differentiable)."""
    H, io = field.hidden_channels, field.input_option
    we1 = field.emb.weight[:, :H].t()             # [in, out]
    w_in = field.linear_in.weight                 # [HH, 2 + H] or [HH, H]
    wy = (w_in[:, 2:].t() if io in (4, 6) else w_in.t()) @ we1
    HH = wy.shape[1]
    if len(field.linears):
        w_inner = torch.stack([l.weight.t() for l in field.linears])
        b_inner = torch.stack([l.bias for l in field.linears])
    else:
        w_inner = torch.zeros((0, HH, HH), dtype=torch.float32, device=device)
        b_inner = torch.zeros((0, HH), dtype=torch.float32, device=device)
    return {"wy": wy.contiguous(), "w_inner": w_inner, "b_inner": b_inner,
            "wout": field.linear_out.weight.t().contiguous(),
            "bo": field.linear_out.bias}


def merged_drift_rows(field, path, tv: np.ndarray, t: torch.Tensor):
    """The y-independent parts of the merged drift input at stage times tv
    [M] (host float64; `t` is the same times as a float32 tensor on the
    device): the hoist xh' = (X(t) W_init + b_init) We2 [M, B, HH] (one
    [M*B, C] product) and a' = (tf Wt + b_in) We1 + be [M, HH]
    (differentiable)."""
    H, io = field.hidden_channels, field.input_option
    we = field.emb.weight                         # [H, 2H] (torch layout)
    we1, we2 = we[:, :H].t(), we[:, H:].t()       # [in, out]
    xh = field.initial_network(path.evaluate_grid(tv)) @ we2
    w_in = field.linear_in.weight
    if io in (4, 6):
        tf = torch.stack([torch.sin(t), torch.cos(t)], dim=-1)   # [M, 2]
        a = tf @ w_in[:, :2].t() + field.linear_in.bias
    else:
        a = field.linear_in.bias.expand(len(tv), -1)
    a = a @ we1 + field.emb.bias
    return xh.contiguous(), a.contiguous()


def stage_times(device, *tvs: np.ndarray) -> torch.Tensor:
    """Host stage-time vectors [M] as rows of one float32 tensor on the
    device: one host-to-device copy (each copy from pageable host memory
    waits for the stream)."""
    return torch.as_tensor(np.stack(tvs), dtype=torch.float32, device=device)
