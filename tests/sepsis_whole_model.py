"""The whole sepsis model's check, the part that needs no JAX (imported by
tests/test_torch_whole_model.py on the CPU and tests/test_torch_cuda.py on
the card, and read by chip_smoke.py's phase of the same check).

The sepsis flagship model at full width (C = 69 input channels, H = HH =
49, two hidden layers, LNSDE (4,17), the static encoder and the BatchNorm
readout, dropout at rate 0) on a batch of 32 series of 24 hourly points:
its inputs, every parameter and the Brownian increments are drawn with
numpy from one seed, so both packages build the same model and data. The
JAX package's train-mode loss (masked BCE with pos_weight 10 plus the
field's L2 term) and every gradient are kept in GOLDEN, written by the
CPU test; the port's are held to them: the loss within 1e-5 relative,
every gradient within 1e-4 of its largest entry, the BatchNorm-cancelled
readout bias at its sibling weight's scale (ROADMAP "A trap for parity
tests").
"""

from __future__ import annotations

import os

import numpy as np

SEED = 11
B, L, C, H, S, LAYERS = 32, 24, 69, 49, 4, 2
MODEL = "neurallnsde"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "sepsis_whole_model.npz")
TOL_LOSS, TOL_GRAD = 1e-5, 1e-4
CANCELLED = "sde.readout.linear1.bias"


def data():
    """The batch: times [L], x [B, L, C], static [B, S], y [B],
    final_index [B], mask [B] (three padded rows), dW [L-1, B, H]."""
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    static = rng.normal(size=(B, S)).astype(np.float32)
    y = (rng.random(B) < 0.3).astype(np.float32)
    final_index = rng.integers(L // 2, L, size=B).astype(np.int64)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    dW = rng.normal(size=(L - 1, B, H)).astype(np.float32)   # dt = 1
    return dict(times=np.arange(L, dtype=np.float32), x=x, static=static,
                y=y, final_index=final_index, mask=mask, dW=dW)


def params(shapes: dict) -> dict:
    """Every leaf of the model, keyed and shaped as the JAX model's
    (shapes: key -> shape), drawn from the seed in key order: a weight
    [in, out] normal / sqrt(in), a bias 0.1 normal, theta 1, BatchNorm's
    scale and running variance 1, offset and running mean 0."""
    rng = np.random.default_rng(SEED + 1)
    out = {}
    for key in sorted(shapes):
        shape = tuple(shapes[key])
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("scale", "running_var"):
            v = np.ones(shape)
        elif leaf in ("offset", "running_mean"):
            v = np.zeros(shape)
        elif leaf == "theta":
            v = np.ones(shape)
        elif leaf == "weight":
            v = rng.normal(size=shape) / np.sqrt(shape[0])
        else:
            v = 0.1 * rng.normal(size=shape)
        out[key] = v.astype(np.float32)
    return out


def port_model(device="cpu"):
    """The port's sepsis model (dropout at rate 0) with params() loaded."""
    import torch

    from snsde_torch.convert import _name_map, load_jax_arrays
    from snsde_torch.harness.classification import (InitialValueModel,
                                                    make_sde_model)

    sde, _ = make_sde_model(MODEL, C, H, H, LAYERS, 1, initial=False)
    model = InitialValueModel(S, H, sde)
    model.sde.readout.dropout.rate = 0.0
    state = model.state_dict()
    shapes = {j: tuple(state[p].shape[::-1] if tr else state[p].shape)
              for p, (j, tr) in _name_map(model).items()}
    load_jax_arrays(model, params(shapes))
    return model.to(torch.device(device))


def port_loss_and_grads(model, d, generator=None):
    """The port's train-mode loss and every gradient in the JAX layout (the
    model on its device; the increments come from the solver's sampler)."""
    import torch

    from snsde_torch.convert import grads_to_jax_layout
    from snsde_torch.ops import hermite_cubic_coeffs
    from snsde_torch.train import loop as tloop

    dev = next(model.parameters()).device
    coeffs = hermite_cubic_coeffs(torch.as_tensor(d["times"]),
                                  torch.as_tensor(d["x"])).to(dev)
    batch = {"coeffs": coeffs,
             "static": torch.as_tensor(d["static"], device=dev),
             "final_index": torch.as_tensor(d["final_index"], device=dev),
             "y": torch.as_tensor(d["y"], device=dev),
             "_mask": torch.as_tensor(d["mask"], device=dev)}

    def apply_fn(m, b, gen):
        return m(d["times"], b["coeffs"], b["static"], b["final_index"],
                 generator=gen)[..., 0]

    loss_fn = tloop.make_loss_fn(apply_fn, lambda m: m.sde.func,
                                 tloop.TrainConfig(pos_weight=10.0))
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch, generator)
    loss.backward()
    return float(loss.detach()), grads_to_jax_layout(model)


def check(loss, grads, golden) -> dict:
    """Hold a loss and gradients to the golden's; returns each gradient's
    largest error over its scale."""
    ref_loss = float(golden["loss"])
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss), (
        f"loss {loss!r} against {ref_loss!r}")
    errs = {}
    for key in golden.files:
        if not key.startswith("grad."):
            continue
        name = key[5:]
        ref = golden[key]
        scale = float(np.abs(ref).max())
        if name == CANCELLED:
            scale = max(scale, float(np.abs(
                golden["grad." + name[:-4] + "weight"]).max()))
        err = float(np.abs(grads[name] - ref).max())
        errs[name] = err / max(scale, 1e-30)
        assert err <= TOL_GRAD * scale, (
            f"grad {name}: {err:.2e} of {scale:.2e}")
    return errs
