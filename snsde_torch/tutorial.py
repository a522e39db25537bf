"""The OU-process tutorial (counterpart of examples/ou_tutorial.py): train
one model family on synthetic Ornstein–Uhlenbeck paths, then run the
notebook's theory check for it.

    python -m snsde_torch.tutorial --model lnsde --epochs 50
    python -m snsde_torch.tutorial --model gsde --solver srk
    python -m snsde_torch.tutorial --model lsde-kld --device cpu

Models: ode | cde | sde | lsde | lnsde | gsde | sde-kld | lsde-kld.
`ode` is `NDEModel(NeuralSDEFunc)` with its diffusion net's output layer
zeroed inside the forward (its gradient there stays 0); `sde` .. `gsde`
are `NDEModel` with the tutorial field of that name (the eager sdeint, as
in JAX); `cde` is `NeuralCDEStream` with `FinalTanh` (rk4, the CDE
kernels on the card); `*-kld` is `LatentSDE` trained on the reconstruction
error plus kl_weight x its KL (euler: the EM kernels' latent instances on
the card). Each epoch is one Adam step on the whole training split (800
paths of the default 1000).

Theory checks (tutorial/README.md:7-19), each returned with whether it
holds:
  ode       determinism across noise seeds (mean |delta| < 1e-6)
  cde       |f(z0)| of the control Jacobian (finite)
  sde       trajectory shift across noise seeds (> 0)
  lsde      diffusion state-independence, g(t, y) == g(t, flip(y)) (< 1e-6)
  lnsde     |sigma(t)| over a long horizon (finite, bounded)
  gsde      latent positivity fraction of a solve from |z0| (in [0, 1])
  *-kld     ELBO decomposition, the KL >= 0

Runs on CUDA unless `device` says otherwise; raises without a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from . import resolve_device
from .data.ou import generate_ou_paths
from .fields import (NeuralGSDEFunc, NeuralLNSDEFunc, NeuralLSDEFunc,
                     NeuralSDEFunc)
from .models.latent_sde import LatentSDE
from .models.neuralcde import FinalTanh, NeuralCDEStream
from .models.neuralsde import NDEModel
from .ops.interp import CubicPath, hermite_cubic_coeffs
from .ops.solve import sdeint

__all__ = ["FIELDS", "KINDS", "SOLVERS", "make_data", "build_model",
           "train", "theory_check", "main"]

FIELDS = {"sde": NeuralSDEFunc, "lsde": NeuralLSDEFunc,
          "lnsde": NeuralLNSDEFunc, "gsde": NeuralGSDEFunc}
KINDS = ("ode", "cde", "sde", "lsde", "lnsde", "gsde", "sde-kld", "lsde-kld")
SOLVERS = ("euler", "srk", "milstein", "heun")


def make_data(n: int = 1000, N: int = 20, *, generator, device):
    """(times [N] numpy, train coeffs, train values [n_tr, N], test coeffs,
    test values): OU paths (theta 0.2, mu 0, sigma 0.1, x0 1, T 10), their
    Hermite coefficients, the first 80% for training."""
    data, times = generate_ou_paths(n, T=10.0, N=N, theta=0.2, mu=0.0,
                                    sigma=0.1, x0=1.0, generator=generator)
    data = data.to(device)
    times = times.cpu().numpy()
    coeffs = hermite_cubic_coeffs(times, data)
    n_train = int(0.8 * n)
    return (times, coeffs[:n_train], data[:n_train, :, 1],
            coeffs[n_train:], data[n_train:, :, 1])


def build_model(kind: str, solver: str = "euler", hidden: int = 32, *,
                generator: Optional[torch.Generator] = None, device=None):
    """The tutorial's model of `kind` (2 input channels, 1 output)."""
    if kind not in KINDS:
        raise ValueError(f"unknown tutorial model {kind!r}")
    kw = dict(generator=generator, device=device)
    base = kind.replace("-kld", "")
    if kind.endswith("-kld"):
        return LatentSDE(2, hidden, hidden, 1, method=solver, **kw)
    if base == "cde":
        func = FinalTanh(2, hidden, hidden, 1, **kw)
        return NeuralCDEStream(func, 2, hidden, 1, **kw)
    if base == "ode":
        return NDEModel(2, hidden, 1, 1, vector_field=NeuralSDEFunc, **kw)
    return NDEModel(2, hidden, 1, 1, vector_field=FIELDS[base],
                    method=solver, **kw)


def _zero_g(model):
    """{name: zeros} of the diffusion net's output layer, for
    torch.func.functional_call: a zero diffusion (an ODE) whose output
    layer's gradient is exactly 0."""
    last = model.func.g_net.layers[-1]
    pre = f"func.g_net.layers.{len(model.func.g_net.layers) - 1}."
    return {pre + "weight": torch.zeros_like(last.weight),
            pre + "bias": torch.zeros_like(last.bias)}


def _predict(kind, model, coeffs, times, gen):
    """[B, N] predictions of a non-KL model."""
    if kind == "cde":
        return model(times, coeffs)[0][..., 0]
    if kind == "ode":
        return torch.func.functional_call(
            model, _zero_g(model), (coeffs, times),
            {"generator": gen})[..., 0]
    return model(coeffs, times, generator=gen)[..., 0]


def _loss(kind, model, coeffs, y, times, gen, kl_weight):
    """(loss, (reconstruction, KL) for the KL kinds, else None)."""
    if kind.endswith("-kld"):
        out, _, logqp = model(coeffs, times, generator=gen)
        recon = torch.mean((out.mean(-1) - y) ** 2)
        return recon + kl_weight * logqp, (recon, logqp)
    return torch.mean((_predict(kind, model, coeffs, times, gen) - y) ** 2), \
        None


def train(kind: str, solver: str = "euler", epochs: int = 50,
          hidden: int = 32, lr: float = 1e-3, seed: int = 42,
          kl_weight: float = 1e-3, n: int = 1000, verbose: bool = True,
          device=None) -> Dict:
    """Train the tutorial's `kind` for `epochs` full-batch Adam steps and
    run its theory check. The paths and then the initial weights are
    drawn from a CPU generator seeded `seed`; the training noise from one
    on the device seeded `seed`. Returns {"model", "losses" (one a step),
    "test_losses" (every 10th epoch), "check"}."""
    dev = resolve_device(device)
    host = torch.Generator().manual_seed(seed)
    times, tr_c, tr_y, te_c, te_y = make_data(n, generator=host, device=dev)
    model = build_model(kind, solver, hidden, generator=host).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses, test_losses = [], []
    for epoch in range(1, epochs + 1):
        opt.zero_grad(set_to_none=True)
        loss, _ = _loss(kind, model, tr_c, tr_y, times, gen, kl_weight)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if epoch % 10 == 0:
            with torch.no_grad():
                te, _ = _loss(kind, model, te_c, te_y, times, gen, kl_weight)
            test_losses.append(float(te))
            if verbose:
                print(f"epoch {epoch}: train {losses[-1]:.4f} test "
                      f"{test_losses[-1]:.4f}", flush=True)
    with torch.no_grad():
        check = theory_check(kind, model, times, te_c, te_y, gen, solver,
                             verbose=verbose)
    return {"model": model, "losses": losses, "test_losses": test_losses,
            "check": check}


def theory_check(kind, model, times, coeffs, y, generator, solver,
                 verbose: bool = True) -> Dict:
    """The notebook's theory check of `kind` (module docstring): {"name",
    "value", "ok"}, plus the diffusion norm (lsde) and the sigma range
    (lnsde). Raises AssertionError where the JAX tutorial asserts (ode,
    *-kld)."""
    dev = coeffs.device
    gens = [torch.Generator(device=dev).manual_seed(s) for s in (0, 1)]
    t0 = torch.as_tensor(times[0], device=dev)
    out: Dict = {"kind": kind}
    if kind in ("ode", "sde"):
        p1, p2 = (_predict(kind, model, coeffs, times, g) for g in gens)
        shift = float((p1 - p2).abs().mean())
        ok = shift < 1e-6 if kind == "ode" else shift > 0.0
        out.update(name="shift across noise seeds", value=shift, ok=ok)
    elif kind == "cde":
        path = CubicPath(coeffs, times)
        z0 = model.initial_network(path.evaluate(path.times[0]))
        norm = float(torch.linalg.norm(model.func(path.times[0], z0)))
        out.update(name="control-Jacobian |f(z0)|", value=norm,
                   ok=bool(np.isfinite(norm)))
    elif kind in ("lsde", "lnsde", "gsde"):
        path = CubicPath(coeffs, times)
        func = model.func.bind(path)
        y0 = model.initial(path.evaluate(path.times[0]))
        if kind == "lsde":
            err = float((func.g(t0, y0) - func.g(t0, y0.flip(-1))).abs()
                        .max())
            norms = [float(torch.linalg.norm(func.g(t, y0[:1])))
                     for t in torch.linspace(0, 1, 20, device=dev)]
            out.update(name="state-independence error", value=err,
                       ok=err < 1e-6, diffusion_norm=float(np.mean(norms)))
        elif kind == "lnsde":
            sig = [float(func.g(t, y0).abs().mean())
                   for t in torch.linspace(0, 3, 30, device=dev)]
            out.update(name="|sigma(t)| at t = 3", value=sig[-1],
                       ok=bool(np.isfinite(sig).all()), sigma_start=sig[0])
        else:
            zs = sdeint(func.f, func.g, y0.abs(), times,
                        generator=generator, dt=0.05, method=solver)
            frac = float((zs > 0).float().mean())
            out.update(name=f"latent positivity fraction ({solver})",
                       value=frac, ok=0.0 <= frac <= 1.0)
    else:
        o, _, logqp = model(coeffs, times, generator=generator)
        recon = float(torch.mean((o.mean(-1) - y) ** 2))
        out.update(name="KL of the ELBO", value=float(logqp),
                   ok=float(logqp) >= 0.0, reconstruction=recon)
    if verbose:
        print(f"theory check {kind}: {out['name']} = {out['value']:.4g} "
              f"({'holds' if out['ok'] else 'FAILS'})", flush=True)
    if (kind == "ode" or kind.endswith("-kld")) and not out["ok"]:
        raise AssertionError(f"theory check failed: {out}")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="python -m snsde_torch.tutorial")
    ap.add_argument("--model", default="lnsde", choices=KINDS)
    ap.add_argument("--solver", default="euler", choices=SOLVERS)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    return train(a.model, a.solver, a.epochs, a.hidden, a.lr, a.seed,
                 n=a.n, device=a.device)


if __name__ == "__main__":
    main()
