"""The port's convolution and attention baselines (`cnn`, `cnn-3/5/7`:
models/rnn.py SeqCNN; `transformer`: SeqTransformer) against the JAX
package on the CPU. Neither has a kernel, in either package.

Each model is built by both packages, its weights carried over by
snsde_torch.convert, and run on the same input drawn with numpy: the
output, the stream and every parameter's gradient of a sum of squares of
both, within rtol 1e-4 and an atol of 1e-6 times the larger of 1 and the
leaf's largest entry (float32 convolutions and attention, the sums in
another order; the gradient of a bias just before the transformer's
non-affine norm is a difference of entries up to 20 that cancels to
~1e-2, 2.4e-6 from JAX's). The registry layers the same way, on a
preprocessed batch.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde import registry as jreg
from snsde.harness import robustness as jrob
from snsde.models import rnn as jrnn
from snsde.nn.core import filter_value_and_grad

from snsde_torch import registry as treg
from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.harness import robustness as trob
from snsde_torch.models import rnn as trnn

from test_torch_obs_rnn import _batch, _port_loss_grads, jax_arrays

RTOL, ATOL = 1e-4, 1e-6
NAMES = ("cnn", "cnn-3", "cnn-5", "cnn-7", "transformer")


def _close(what, ours, theirs):
    assert set(ours) == set(theirs), (what, set(ours) ^ set(theirs))
    for k, ref in theirs.items():
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(ours[k], ref, rtol=RTOL,
                                   atol=ATOL * scale, err_msg=f"{what} {k}")


def _jax_loss_grads(layer, seq, coeffs):
    """The JAX layer's loss (a sum of squares of its output and stream)
    and every leaf's gradient, jitted."""
    def loss(m):
        out, hn = m(jnp.asarray(seq), jnp.asarray(coeffs))
        return jnp.sum(out ** 2) + jnp.sum(hn ** 2)

    l, g = jax.jit(filter_value_and_grad(loss))(layer)
    return float(l), jax_arrays(g)


def _compare(jm, tm, x):
    def jloss(m):
        out, h = m(jnp.asarray(x))
        return jnp.sum(out ** 2) + jnp.sum(h ** 2), (out, h)

    (jl, (jo, jh)), jg = jax.jit(filter_value_and_grad(
        jloss, has_aux=True))(jm)
    out, h = tm(torch.as_tensor(x))
    loss = (out ** 2).sum() + (h ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    _close(type(tm).__name__, grads_to_jax_layout(tm), jax_arrays(jg))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_seq_cnn_matches_jax(k):
    """SeqCNN of kernel k and depth 2 ("SAME" padding, cross-correlation
    as both packages compute it)."""
    x = np.random.default_rng(k).normal(size=(4, 13, 3)).astype(np.float32)
    jm = jrnn.SeqCNN.create(jax.random.PRNGKey(k), 3, 6, 5, kernel_size=k,
                            depth=2)
    tm = trnn.SeqCNN(3, 6, 5, kernel_size=k, depth=2)
    load_jax_arrays(tm, jax_arrays(jm))
    _compare(jm, tm, x)


@pytest.mark.parametrize("hidden,heads,layers", [(8, 4, 2), (6, 1, 1)])
def test_seq_transformer_matches_jax(hidden, heads, layers):
    """SeqTransformer: the sinusoidal positions, multi-head attention and
    the non-affine post-norm as JAX writes them."""
    x = np.random.default_rng(hidden).normal(size=(3, 9, 4)).astype(
        np.float32)
    jm = jrnn.SeqTransformer.create(jax.random.PRNGKey(1), 4, hidden, 5,
                                    num_heads=heads, num_layers=layers)
    tm = trnn.SeqTransformer(4, hidden, 5, num_heads=heads,
                             num_layers=layers)
    load_jax_arrays(tm, jax_arrays(jm))
    _compare(jm, tm, x)


@pytest.mark.parametrize("name", NAMES)
def test_registry_layer_matches_jax(name):
    """The registry's layer of each name at hidden 8 (4 heads) and two
    layers: loss and every leaf's gradient; the leaves' names and shapes
    are JAX's, and so is the coefficient family."""
    seq, coeffs = _batch()
    jl = jreg.make_seq_layer(jax.random.PRNGKey(3), name, 4, 11, 8,
                             num_layers=2)
    tl = treg.make_seq_layer(name, 4, 11, 8, num_layers=2)
    theirs = {k: v.shape for k, v in jax_arrays(jl).items()}
    assert {k: v.shape for k, v in grads_to_jax_layout(tl).items()} == theirs
    load_jax_arrays(tl, jax_arrays(jl))
    wl, wg = _jax_loss_grads(jl, seq, coeffs)
    gl, gg = _port_loss_grads(tl, seq, coeffs)
    np.testing.assert_allclose(gl, wl, rtol=RTOL)
    _close(name, gg, wg)
    assert name in treg.PORTED_NAMES
    assert trob.coeff_family(name) == jrob.coeff_family(name)


def test_registry_sizes_as_jax():
    """cnn-k takes kernel k and depth max(num_layers, 1); transformer one
    head where hidden % 4 != 0."""
    for layers in (0, 3):
        tl = treg.make_seq_layer("cnn-5", 4, 11, 6, num_layers=layers)
        assert len(tl.inner.kernels) == max(layers, 1)
        assert tl.inner.kernels[0].shape == (5, 4, 6)
    assert treg.make_seq_layer("transformer", 4, 11, 6).inner.num_heads == 1
    assert treg.make_seq_layer("transformer", 4, 11, 8).inner.num_heads == 4
