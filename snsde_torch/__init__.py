"""snsde_torch — Stable Neural SDEs on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of the JAX package `snsde`, which stays in the repository
as its reference. Module names mirror the JAX package (`snsde_torch.fields`
is the counterpart of `snsde.fields`, and so on); inside, the port uses
PyTorch idiom: `nn.Module`s, an explicit `device`, explicit
`torch.Generator`s, and a `torch.autograd.Function` around each hand-written
CUDA kernel.

The numeric regime is exact float32, the same as the JAX package's
`jax_default_matmul_precision="highest"` pin: TF32 is off for matrix
products and for cuDNN.

Entry points run on the card by default (`device="cuda"`) and raise when no
CUDA device is present; only an explicit `device="cpu"` runs on the CPU,
where every kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else CUDA.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device is present — the port never moves work to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "snsde_torch runs on a CUDA device by default and none is "
            "present; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU"
        )
    return dev
