"""bench.py's training configuration in bench.py's precision (bf16x3
operands, bf16 streams) and in exact fp32, side by side in the JAX package
and in the port, on the CPU.

The JAX side trains through its fused EM kernel in Pallas interpret mode
(SNSDE_FUSED_INTERPRET=1), the precision set through SNSDE_FUSED_STREAM and
SNSDE_FUSED_MATMUL as bench.py sets it (the JAX models reach the kernel only
on a TPU, so the script calls fused_em_solve itself, as NeuralSDE.solve
would there); the port trains through its plain versions (what its
wrappers take for CPU tensors, and what chip_smoke.py holds the CUDA
kernels against). Both start from the same leaves (snsde_torch.convert),
take the same batch and the same Brownian increments every step
(dW_override=), the same loss (BCE with pos_weight 10 and the field's
weight regularisation) and AdamW(1e-3, weight decay 0.01). The readout's
dropout is off on both sides (no key, no generator: both packages' Dropout
is the identity then), so that the runs differ only in the solve.

Prints, step by step, each side's loss in each precision, each side's
reduced-vs-fp32 gap and the port-vs-JAX gap in each precision, all
relative to JAX's fp32 loss, and the yardstick of rounding alone: JAX's
run in bench.py's precision beside JAX's run in it from the same leaves
nudged one float32 ulp up (np.nextafter), with the same batches and
increments. The last line is one JSON object of them.

    JAX_PLATFORMS=cpu python tests/torch_bench_precision.py [B [L [STEPS]]]

Defaults: B=32, L=12 hourly times (11 Euler steps), 10 steps, C=35 and
H=HH=49 as bench.py. Not collected as a test module: it imports the JAX
package and takes a few minutes."""

import json
import os
import sys
import time

import numpy as np
import torch

os.environ["SNSDE_FUSED_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from snsde.harness import classification as jcls  # noqa: E402
from snsde.kernels.fused_em import fused_em_solve as jax_solve  # noqa: E402
from snsde.nn.core import (combine, filter_value_and_grad,  # noqa: E402
                           partition)
from snsde.ops.interp import CubicPath as JaxPath  # noqa: E402
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite  # noqa: E402
from snsde.train import loop as jloop  # noqa: E402

from snsde_torch.convert import load_jax_arrays  # noqa: E402
from snsde_torch.harness import classification as tcls  # noqa: E402
from snsde_torch.kernels.fused_em import fused_em_solve  # noqa: E402
from snsde_torch.models.neuralsde import resolve_dt  # noqa: E402
from snsde_torch.ops import CubicPath, hermite_cubic_coeffs, make_grid  # noqa: E402
from snsde_torch.train import loop as tloop  # noqa: E402

C, H, LAYERS, MODEL = 35, 49, 2, "neurallnsde"
LR, WD, POS_WEIGHT = 1e-3, 0.01, 10.0
# (operand mode, stream dtype): bench.py's precision, and exact fp32
PRECISIONS = {"bench": ("bf16x3", "bf16"), "fp32": ("f32", "f32")}


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path, the key format of
    snsde_torch.convert."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def batch(B, L, seed=0):
    """bench.py's batch at (B, L): hourly times, a time channel and C - 1
    N(0, 1) channels, ~10% positive labels; and each step's increments."""
    rng = np.random.default_rng(seed)
    times = np.arange(L, dtype=np.float32)
    X = rng.normal(size=(B, L, C - 1)).astype(np.float32)
    tchan = np.broadcast_to(times[None, :, None], (B, L, 1))
    Xa = np.concatenate([tchan, X], axis=-1)
    y = (rng.random(B) < 0.1).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    return times, Xa, y, grid


def increments(step, grid, B):
    rng = np.random.default_rng(1000 + step)
    return (rng.normal(size=(len(grid) - 1, B, H))
            * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)


def nudged(tree):
    """The tree with every float leaf one float32 ulp up."""
    return jax.tree_util.tree_map(
        lambda a: (jnp.asarray(np.nextafter(np.asarray(a), np.float32(np.inf)))
                   if hasattr(a, "dtype") and a.dtype == jnp.float32 else a),
        tree)


def jax_run(jmodel, data, precision, steps):
    """JAX's losses, the precision set through the environment."""
    times, Xa, y, grid = data
    os.environ["SNSDE_FUSED_MATMUL"], os.environ["SNSDE_FUSED_STREAM"] = \
        PRECISIONS[precision]
    B, L = y.shape[0], len(times)
    coeffs = jax_hermite(jnp.asarray(times), jnp.asarray(Xa))
    yj = jnp.asarray(y)
    final = jnp.full((B,), L - 1, jnp.int32)

    def loss_fn(m, dW):
        path = JaxPath(coeffs, times)
        z0 = m.initial_network(path.evaluate(jnp.asarray(times)[0]))
        zs = jax_solve(m.func.bind(path), path, times, z0,
                       jax.random.PRNGKey(0), dt=resolve_dt(times),
                       dW_override=dW)
        z = jnp.take_along_axis(jnp.moveaxis(zs, 0, 1),
                                final[:, None, None], axis=1)[:, 0]
        pred, readout = m.readout(z, train=True)
        loss = jloop.bce_with_logits(pred[..., 0], yj, pos_weight=POS_WEIGHT)
        return (loss + jloop.weight_regularization(m.func),
                m.replace(readout=readout))

    vg = filter_value_and_grad(loss_fn, has_aux=True)
    tx = optax.adamw(LR, weight_decay=WD)
    params, _ = partition(jmodel)
    opt_state = tx.init(params)

    @jax.jit
    def step(m, os_, dW):
        (loss, new_m), grads = vg(m, dW)
        p, rest = partition(new_m)
        updates, os2 = tx.update(grads, os_, p)
        return combine(optax.apply_updates(p, updates), rest), os2, loss

    losses, m = [], jmodel
    for i in range(steps):
        m, opt_state, loss = step(m, opt_state,
                                  jnp.asarray(increments(i, grid, B)))
        losses.append(float(loss))
    del os.environ["SNSDE_FUSED_MATMUL"], os.environ["SNSDE_FUSED_STREAM"]
    return losses


def port_run(leaves, data, precision, steps):
    """The port's losses through its plain versions, the precision asked
    by argument."""
    times, Xa, y, grid = data
    matmul, stream = PRECISIONS[precision]
    B, L = y.shape[0], len(times)
    model, reg = tcls.make_sde_model(MODEL, C, H, H, LAYERS, 1)
    load_jax_arrays(model, leaves)
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    coeffs = hermite_cubic_coeffs(torch.as_tensor(times), torch.as_tensor(Xa))
    yt = torch.as_tensor(y)
    losses = []
    for i in range(steps):
        path = CubicPath(coeffs, times)
        z0 = model.initial_network(path.evaluate(path.times[0]))
        zs = fused_em_solve(model.func.bind(path), path, times, z0,
                            dt=resolve_dt(times),
                            dW_override=torch.as_tensor(
                                increments(i, grid, B)),
                            stream_dtype=(torch.bfloat16 if stream == "bf16"
                                          else torch.float32),
                            matmul=matmul)
        pred = model.readout(zs[L - 1])
        loss = (tloop.bce_with_logits(pred[..., 0], yt,
                                      pos_weight=POS_WEIGHT)
                + tloop.weight_regularization(reg(model)))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def main(B=32, L=12, steps=10):
    t0 = time.perf_counter()
    data = batch(B, L)
    jmodel, _ = jcls.make_sde_model(jax.random.PRNGKey(0), MODEL, C, H, H,
                                    LAYERS, 1)
    leaves = jax_arrays(jmodel)
    out = {}
    for precision in PRECISIONS:
        out[f"jax {precision}"] = jax_run(jmodel, data, precision, steps)
        out[f"port {precision}"] = port_run(leaves, data, precision, steps)
        print(f"{precision}: done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    out["jax bench nudged"] = jax_run(nudged(jmodel), data, "bench", steps)
    rel = lambda a, b: [abs(x - y) / abs(f) for x, y, f
                        in zip(a, b, out["jax fp32"])]
    gaps = {"jax bench - jax fp32": rel(out["jax bench"], out["jax fp32"]),
            "port bench - port fp32": rel(out["port bench"],
                                          out["port fp32"]),
            "port fp32 - jax fp32": rel(out["port fp32"], out["jax fp32"]),
            "port bench - jax bench": rel(out["port bench"],
                                          out["jax bench"]),
            "jax bench nudged - jax bench": rel(out["jax bench nudged"],
                                                out["jax bench"])}
    print(f"bench.py's configuration at B={B}, L={L} ({L - 1} Euler steps),"
          f" C={C}, H=HH={H}: {steps} AdamW steps; gaps relative to JAX's "
          f"fp32 loss")
    print("step " + " ".join(f"{k:>14}" for k in out)
          + " " + " ".join(f"{k:>24}" for k in gaps))
    for i in range(steps):
        print(f"{i:4d} " + " ".join(f"{v[i]:14.8f}" for v in out.values())
              + " " + " ".join(f"{v[i]:24.3e}" for v in gaps.values()))
    print(json.dumps({"B": B, "L": L, "steps": steps, "losses": out,
                      "gaps": gaps,
                      "seconds": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
