"""What the fused solver kernel pairs (fused_em.py, fused_srk.py) share on
the Python side, as csrc/sde_common.cuh holds what they share on the
device: the modes they take, the input checks, the loaded library with its
common C interface, and the precomputes outside the kernels (the merged
drift's weights and rows, the diffusion magnitude gk(t), the stage times).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = ["MAX_WIDTH", "EMB_IO", "PRECOMP_NO", "MULT_Y_NO", "SolverLib",
           "supports_fused", "check_supported", "check_tensors",
           "kernel_dims", "precomp_gk", "merged_drift_weights",
           "merged_drift_rows", "stage_times"]

MAX_WIDTH = 128
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
    the wrong rank or on H, HH above MAX_WIDTH."""
    if y0.ndim != 2 or wy.ndim != 2 or w_inner.ndim != 3 or dts.ndim != 1:
        raise ValueError(f"{label} kernel: y0 [B,H], wy [H,HH], w_inner "
                         "[n_inner,HH,HH] and dts [M] expected")
    B, H = y0.shape
    HH = wy.shape[1]
    if H > MAX_WIDTH or HH > MAX_WIDTH:
        raise ValueError(f"{label} kernel takes H and HH up to {MAX_WIDTH} "
                         f"(got H={H}, HH={HH})")
    return dts.shape[0], B, H, HH, w_inner.shape[0]


_P = ctypes.c_void_p
_I = ctypes.c_int


class SolverLib:
    """The library of one kernel pair, csrc/<name>.cu, built and loaded at
    first use (never at construction). Every such library has the same C
    interface: <name>_fwd and <name>_bwd (tensor pointers, then M, B, H, HH,
    n_inner, mult_y, geometric, then the stream), <name>_smem_bytes,
    <name>_max_smem, <name>_rows_per_block and <name>_error_string.
    `label` names the pair in errors."""

    def __init__(self, name: str, label: str, n_fwd_ptrs: int,
                 n_bwd_ptrs: int):
        self.name, self.label = name, label
        self._n_ptrs = {"fwd": n_fwd_ptrs, "bwd": n_bwd_ptrs}

    @functools.cached_property
    def _lib(self) -> ctypes.CDLL:
        from ._build import load

        lib = load(self.name)
        fn = lambda suffix: getattr(lib, f"{self.name}_{suffix}")
        for which, n in self._n_ptrs.items():
            fn(which).argtypes = [_P] * n + [_I] * 7 + [_P]
            fn(which).restype = _I
        fn("smem_bytes").argtypes = [_I] * 4
        fn("smem_bytes").restype = ctypes.c_longlong
        fn("error_string").argtypes = [_I]
        fn("error_string").restype = ctypes.c_char_p
        for suffix in ("max_smem", "rows_per_block"):
            fn(suffix).argtypes = []
            fn(suffix).restype = _I
        return lib

    def _fn(self, suffix: str):
        return getattr(self._lib, f"{self.name}_{suffix}")

    def rows_per_block(self) -> int:
        return self._fn("rows_per_block")()

    def stream(self, y0, dims, backward: bool) -> int:
        """The current CUDA stream's handle, after checking that y0 is on
        CUDA (before anything is built) and that the launch's shared memory
        fits the device: ValueError otherwise."""
        if y0.device.type != "cuda":
            raise ValueError(f"the {self.label} kernels take CUDA tensors; "
                             f"got {y0.device}")
        _, _, H, HH, n_inner = dims
        need = self._fn("smem_bytes")(H, HH, n_inner, int(backward))
        limit = self._fn("max_smem")()
        if need > limit:
            what = ("backward kernel keeps weights and gradient accumulators"
                    if backward else "forward kernel keeps weights")
            raise ValueError(
                f"{self.label} {what} in shared memory: H={H}, HH={HH}, "
                f"n_inner={n_inner} needs {need} bytes, above this device's "
                f"{limit}-byte limit per block")
        return torch.cuda.current_stream(y0.device).cuda_stream

    def launch(self, which: str, tensors, dims, mult_y: bool,
               geometric: bool, stream: int) -> None:
        """Run <name>_<which> ('fwd' or 'bwd') on the tensors' pointers;
        RuntimeError with the CUDA error if the launch fails."""
        err = self._fn(which)(*(t.data_ptr() for t in tensors), *dims,
                              int(mult_y), int(geometric), stream)
        if err != 0:
            msg = self._fn("error_string")(err).decode()
            part = "forward" if which == "fwd" else "backward"
            raise RuntimeError(f"{self.label} {part} kernel launch failed: "
                               f"{msg}")


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
