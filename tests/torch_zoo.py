"""Helpers of the model-zoo parity tests (tests/test_torch_{ancde,flows,
attn_mtan}.py): carry a JAX model's leaves into its port, run both, and
compare outputs and every parameter gradient.

Tolerances: outputs to the port's CDE tolerance, 1e-5 absolute
(tests/test_torch_cde.py); each parameter gradient to 1e-4 of its largest
entry, that scale floored at 1e-3 of the model's largest gradient and,
for a bias, at its sibling weight's, so a gradient that is 0 in truth
(float32 noise on both sides: a bias before a train-mode BatchNorm) is
held at its siblings' scale (ROADMAP's trap for parity tests).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from snsde.nn.core import filter_value_and_grad

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays

from test_torch_fused_em import jax_arrays

TOL = 1e-5
GRAD_TOL = 1e-4


def carry(jm, tm):
    """Load the JAX model jm's leaves into the port model tm: every JAX
    leaf lands and every port parameter and buffer is filled (load_jax_
    arrays raises on a key on one side only), and the parameter keys are
    the JAX model's float leaves."""
    arrays = jax_arrays(jm)
    load_jax_arrays(tm, arrays)
    params = set(grads_to_jax_layout(tm))
    buffers = {k for k in arrays if k.endswith(("running_mean",
                                                "running_var"))}
    assert params == set(arrays) - buffers
    return tm


def jax_value_and_grads(loss, jm):
    """(aux, gradient leaves keyed as jax_arrays) of loss(m) -> (value,
    aux) at jm, under jit (one compile is faster than the scans' op by op
    dispatch)."""
    (_, aux), g = jax.jit(filter_value_and_grad(loss, has_aux=True))(jm)
    return aux, jax_arrays(g)


def assert_close(ours, ref, atol=TOL, name=""):
    ours = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    assert np.isfinite(ours).all(), name
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0, err_msg=name)


def grad_errors(tm, ref: dict) -> dict:
    """{leaf: largest |ours - ref| over its scale} of the port model's
    gradients against the JAX gradient leaves."""
    ours = grads_to_jax_layout(tm)
    assert set(ours) == set(ref)
    top = max(float(np.abs(v).max()) for v in ref.values() if v.size)
    out = {}
    for k, r in ref.items():
        if not r.size:
            continue
        scale = max(float(np.abs(r).max()), 1e-3 * top)
        sibling = ref.get(k[:-len("bias")] + "weight")
        if k.endswith(".bias") and sibling is not None:
            scale = max(scale, float(np.abs(sibling).max()))
        out[k] = float(np.abs(ours[k] - r).max()) / scale
    return out


def assert_grads_match(tm, ref: dict, tol=GRAD_TOL):
    bad = {k: e for k, e in grad_errors(tm, ref).items() if not e <= tol}
    assert not bad, bad


def probe_noise(seed: int, shape):
    """JAX's own probe or sample noise: jax.random.normal(PRNGKey(seed),
    shape) (float32), with the key to hand the JAX model."""
    key = jax.random.PRNGKey(seed)
    return key, torch.as_tensor(np.array(jax.random.normal(key, shape,
                                                           jnp.float32)))
