"""SAnD, MIAM and mTAN (snsde_torch/models/{attn,mtan}.py) against the JAX
package on the CPU: SAnD's dense interpolation and MIAM's time-descriptor
encoding against the reference loops of tests/test_zoo_behavior.py:116-165,
SAnD's positional table; MIAM's masked keys fully blocked and its decoder
tied at initialisation; the dropout keep-rate of the port's own draws in
train mode; MIAM's classification head in eval and train mode; `MultiTimeAttention`, `MTANEncoder`, `MTANDecoder`, `DecRNN3`,
`MTANClassifier` and `LatentClassifier`, the reference grid `query`'s
gradient leaf to leaf; the registry layers `mtan`, `sand` (two blocks of
four heads) and `miam`; and
a short CPU sweep of `ancde`, `leap`, `mtan` and `sand`.

Tolerances (tests/torch_zoo.py): outputs 1e-5 absolute, gradients 1e-4
of their largest entry; the reference loops 1e-6.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.models import attn as jattn
from snsde.models import mtan as jmtan
from snsde.nn.core import filter_value_and_grad
from snsde.registry import make_seq_layer as jax_make_seq_layer

from snsde_torch.data.synthetic import synthetic_uea
from snsde_torch.harness import robustness as trob
from snsde_torch.models import attn as tattn
from snsde_torch.models import mtan as tmtan
from snsde_torch.nn.layers import dropout
from snsde_torch.registry import make_seq_layer

from torch_zoo import (assert_close, assert_grads_match, carry,
                       jax_value_and_grads, probe_noise)

B, L, D, H = 3, 7, 2, 6


def test_dense_interpolation_matches_the_reference_loop():
    Ln, M, Hn = 9, 4, 3
    W = np.zeros((M, Ln), np.float32)
    for t in range(Ln):
        s = (M * (t + 1)) / Ln
        for m_ in range(M):
            W[m_, t] = (1 - abs(s - (1 + m_)) / M) ** 2
    x = np.random.default_rng(0).normal(size=(2, Ln, Hn)).astype(np.float32)
    got = tattn.dense_interpolation(torch.as_tensor(x), M).numpy()
    np.testing.assert_allclose(got, np.einsum("ml,blh->bmh", W, x),
                               rtol=1e-5, atol=1e-6)


def test_positional_tables_match_the_reference():
    """MIAM's table from the observation times against the reference's
    numpy construction; SAnD's per-pair table equal to JAX's (even and odd
    widths)."""
    Bn, Ln, d_model, max_len = 2, 5, 6, 5
    t = np.random.default_rng(0).random((Bn, Ln)).astype(np.float32)
    table = np.array([[t[b] / np.power(max_len, 2 * (j // 2) / d_model)
                       for j in range(d_model)] for b in range(Bn)])
    table[:, 0::2, :] = np.sin(table[:, 0::2, :])
    table[:, 1::2, :] = np.cos(table[:, 1::2, :])
    got = tattn.miam_time_descriptor_pe(torch.as_tensor(t), d_model, max_len)
    np.testing.assert_allclose(got.numpy(), table.transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-6)
    for d in (6, 7):
        np.testing.assert_array_equal(tattn.sand_positional_encoding(10, d),
                                      np.asarray(
                                          jattn.sand_positional_encoding(
                                              10, d)))


def test_miam_blocks_masked_keys_and_ties_its_decoder():
    """Perturbing the observation at a masked key (its first channel's
    delta 0) changes no output; perturbing an open one does. The decoder
    starts as the observation embedding's transpose."""
    g = torch.Generator().manual_seed(4)
    m = tattn.MIAMLayer(3, 8, 6, generator=g).eval()
    dec, emb = m.encoder.decoder.weight, m.encoder.obs_embed.weight
    assert torch.equal(dec, emb.T)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, 6, 3)).astype(np.float32))
    mask = torch.ones(2, 6, 3)
    delta = torch.as_tensor(rng.random((2, 6, 3)).astype(np.float32) + 0.1)
    delta[:, 3, 0] = 0.0
    ts = torch.linspace(0, 1, 6).expand(2, -1)
    with torch.no_grad():
        out = m(x, mask, delta, ts)[0]
        xp = x.clone()
        xp[:, 3] += 5.0
        np.testing.assert_allclose(m(xp, mask, delta, ts)[0].numpy(),
                                   out.numpy(), atol=1e-5)
        xo = x.clone()
        xo[:, 2] += 5.0
        assert float((m(xo, mask, delta, ts)[0] - out).abs().max()) > 1e-3


def test_dropout_keep_rate_and_train_mode():
    """The mask keeps 1 - rate of the entries (within 5 standard
    deviations), scaled by 1 / (1 - rate), from the generator; the
    identity in eval mode or without a generator. SAnD in train mode with
    a generator differs from eval mode, and without one equals it."""
    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0), True)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.9) <= 5 * (0.9 * 0.1 / x.numel()) ** 0.5
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.9, rtol=1e-6)
    assert torch.equal(dropout(x, 0.1, None, True), x)
    assert torch.equal(dropout(x, 0.1, torch.Generator(), False), x)
    s = tattn.SAnDLayer(D, L, H, generator=torch.Generator().manual_seed(1))
    xs = torch.randn(B, L, D, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = s.eval()(xs)[0]
        s.train()
        assert torch.equal(s(xs)[0], ref)
        drawn = s(xs, generator=torch.Generator().manual_seed(3))[0]
        assert not torch.allclose(drawn, ref)


def _loss(res):
    return sum((r ** 2).mean() if i == 0 else r.mean()
               for i, r in enumerate(res))


@pytest.mark.parametrize("train", [False, True])
def test_miam_classification_head_matches_jax(train):
    """MIAMPipeline.classify (mean pool, Linear, BatchNorm, tanh, Linear,
    sigmoid) on given streams, the BatchNorm in eval and in train mode:
    the output, the gradients, and the running statistics after it."""
    rng = np.random.default_rng(3)
    xf, mz = (rng.normal(size=(4, L, 8)).astype(np.float32)
              for _ in range(2))
    jm = jattn.MIAMPipeline.create(jax.random.PRNGKey(5), D, 8, L)
    tm = carry(jm, tattn.MIAMPipeline(D, 8, L)).train(train)

    def loss(m):
        y, new = m.classify(jnp.asarray(xf), jnp.asarray(mz), train=train)
        return jnp.mean(y ** 2), (y, new.clf_norm.running_var.value)

    (y_j, rv_j), ref_g = jax_value_and_grads(loss, jm)
    y_t = tm.classify(torch.as_tensor(xf), torch.as_tensor(mz))
    assert_close(y_t, y_j, name="classify")
    assert_close(tm.clf_norm.running_var, rv_j, name="running_var")
    (y_t ** 2).mean().backward()
    assert_grads_match(tm, ref_g)


# ---------------------------------------------------------------------------
# mTAN
# ---------------------------------------------------------------------------

LQ, LAT, NH = 5, 3, 4
MTAN_MODULES = ["attention", "attention_nomask", "encoder", "decoder",
                "decrnn3", "classifier", "latent_classifier"]


def _mtan_pair(name):
    """(JAX module, port module, call(module, jnp or torch) -> output)."""
    key = jax.random.PRNGKey(MTAN_MODULES.index(name) + 20)
    query = np.linspace(0.0, 1.0, LQ).astype(np.float32)
    if name.startswith("attention"):
        jm = jmtan.MultiTimeAttention.create(key, 2 * D, NH, 8, 2)
        tm = tmtan.MultiTimeAttention(2 * D, NH, 8, 2)
    elif name == "encoder":
        jm = jmtan.MTANEncoder.create(key, D, query, LAT, NH, 8)
        tm = tmtan.MTANEncoder(D, query, LAT, NH, 8)
    elif name == "decoder":
        jm = jmtan.MTANDecoder.create(key, D, query, LAT, NH, 8,
                                      learn_emb=True)
        tm = tmtan.MTANDecoder(D, query, LAT, NH, 8, learn_emb=True)
    elif name == "decrnn3":
        jm = jmtan.DecRNN3.create(key, D, query, LAT, NH)
        tm = tmtan.DecRNN3(D, query, LAT, NH)
    elif name == "classifier":
        jm = jmtan.MTANClassifier.create(key, D, query, NH, 8, 2, 3)
        tm = tmtan.MTANClassifier(D, query, NH, 8, 2, 3)
    else:
        jm = jmtan.LatentClassifier.create(key, LAT, NH, 3)
        tm = tmtan.LatentClassifier(LAT, NH, 3)
    return jm, carry(jm, tm)


def _mtan_inputs():
    rng = np.random.default_rng(6)
    vals = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = (rng.random((B, L, D)) > 0.3).astype(np.float32)
    ts = np.sort(rng.random((B, L)), axis=1).astype(np.float32)
    z = rng.normal(size=(B, LQ, LAT)).astype(np.float32)
    emb_q = rng.normal(size=(LQ, 8)).astype(np.float32)
    emb_k = rng.normal(size=(B, L, 8)).astype(np.float32)
    return dict(x=np.concatenate([vals * mask, mask], -1), ts=ts, z=z,
                emb_q=emb_q, emb_k=emb_k, mask2=np.concatenate([mask, mask],
                                                               -1))


def _mtan_call(name, m, inp, wrap):
    a = {k: wrap(v) for k, v in inp.items()}
    if name == "attention":
        return m(a["emb_q"], a["emb_k"], a["x"], a["mask2"])
    if name == "attention_nomask":
        return m(a["emb_k"], a["emb_k"], a["x"], None)
    if name in ("encoder", "classifier"):
        return m(a["x"], a["ts"])
    if name == "latent_classifier":
        return m(a["z"])
    return m(a["z"], a["ts"])


@functools.lru_cache(maxsize=None)
def _mtan_jax():
    """Every mTAN module's JAX output and gradients in one compile."""
    inp = _mtan_inputs()
    jms = {n: _mtan_pair(n)[0] for n in MTAN_MODULES}

    def loss(ms):
        outs = {n: _mtan_call(n, m, inp, jnp.asarray) for n, m in ms.items()}
        return sum(jnp.mean(o ** 2) for o in outs.values()), outs

    (_, outs), g = jax.jit(filter_value_and_grad(loss, has_aux=True))(jms)
    return inp, jms, outs, g


@pytest.mark.parametrize("name", MTAN_MODULES)
def test_mtan_module_matches_jax(name):
    """The module's output and every parameter gradient of mean(out²),
    the reference grid `query` a parameter with its gradient compared leaf
    to leaf (0 in truth for DecRNN3, whose grid only indexes)."""
    from test_torch_fused_em import jax_arrays

    inp, jms, outs, g = _mtan_jax()
    tm = carry(jms[name], _mtan_pair(name)[1])
    out = _mtan_call(name, tm, inp, torch.as_tensor)
    assert_close(out, outs[name], name=name)
    (out ** 2).mean().backward()
    ref_g = jax_arrays(g[name])
    assert_grads_match(tm, ref_g)
    if hasattr(tm, "query"):
        assert isinstance(tm.query, torch.nn.Parameter)
        if name != "decrnn3":
            assert float(np.abs(ref_g["query"]).max()) > 0


def test_attention_weights_are_masked_softmaxes():
    """attention_weights: rows sum to 1 over the keys; with a mask, one
    softmax a value channel, a masked key's weight 0."""
    inp = _mtan_inputs()
    m = tmtan.MultiTimeAttention(2 * D, NH, 8, 2,
                                 generator=torch.Generator().manual_seed(0))
    q, k = torch.as_tensor(inp["emb_q"]), torch.as_tensor(inp["emb_k"])
    mask = torch.as_tensor(inp["mask2"])
    w = m.attention_weights(q, k)
    np.testing.assert_allclose(w.sum(-1).detach().numpy(), 1.0, atol=1e-6)
    wm = m.attention_weights(q, k, mask).detach()
    assert wm.shape == (B, 2, LQ, L, 2 * D)
    np.testing.assert_allclose(wm.sum(-2).numpy(), 1.0, atol=1e-6)
    blocked = (mask == 0)[:, None, None].expand_as(wm)
    assert float(wm[blocked].max()) < 1e-6


# ---------------------------------------------------------------------------
# The registry layers and the sweep
# ---------------------------------------------------------------------------

REGISTRY = ("mtan", "sand", "miam")
HR = 8


@functools.lru_cache(maxsize=None)
def _jax_registry():
    """A seq with missing values (and a blocked MIAM key), the three JAX
    layers (two SAnD blocks of 4 heads), their outputs and gradients in one
    JAX compile, and mTAN's sample noise as JAX's layer key draws it."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = (rng.random(x.shape) > 0.3).astype(np.float32)
    delta = rng.uniform(0.0, 0.3, size=x.shape).astype(np.float32)
    delta[:, 2, 0] = 0.0
    seq = np.stack([x * mask, mask, delta], axis=1)
    lkey = jax.random.PRNGKey(9)
    jls = {n: jax_make_seq_layer(jax.random.PRNGKey(8), n, D, L, HR,
                                 num_layers=2) for n in REGISTRY}

    def loss(ms):
        res = {n: m(jnp.asarray(seq), None, key=lkey) for n, m in ms.items()}
        return sum(_loss(r) for r in res.values()), res

    (_, res), g = jax.jit(filter_value_and_grad(loss, has_aux=True))(jls)
    return seq, jls, res, g, probe_noise(9, (B, L, HR))[1]


@pytest.mark.parametrize("name", REGISTRY)
def test_registry_layer_matches_jax(name):
    """The registry layer carried from JAX, eval mode, width 8 and two
    layers (SAnD: two blocks of 4 heads): out and hn [B, L, H] and every
    parameter gradient; mTAN's sample noise JAX's own draw from the
    layer's key, passed through `eps`."""
    from test_torch_fused_em import jax_arrays

    seq, jls, res_j, g, eps = _jax_registry()
    tl = carry(jls[name], make_seq_layer(name, D, L, HR,
                                         num_layers=2)).eval()
    res = tl(torch.as_tensor(seq), None,
             eps=eps if name == "mtan" else None)
    assert len(res) == 2 and res[0].shape == res[1].shape == (B, L, HR)
    if name == "sand":
        assert len(tl.inner.blocks) == 2
        assert tl.inner.blocks[0].attn.num_heads == 4
    for i, (a, b) in enumerate(zip(res, res_j[name])):
        assert_close(a, b, name=f"{name} output {i}")
    _loss(res).backward()
    assert_grads_match(tl, jax_arrays(g[name]))


def test_sweep_trains_the_new_names(tmp_path):
    """run_robustness_sweep on the CPU, 2 epochs at n=60, L=12: ancde,
    leap, mtan and sand each write a record with an accuracy and no error;
    leap's training loss is the cross-entropy plus kl_weight x its
    divergence term."""
    cfg = trob.SweepConfig(models=("ancde", "leap", "mtan", "sand"),
                           missing_rates=(0.3,), seeds=(0,), hidden_dim=6,
                           batch_size=16, max_epochs=2,
                           out_dir=str(tmp_path))
    data_fn = lambda n: synthetic_uea(n=n, length=12, channels=2,
                                      num_classes=2, seed=0)
    trained = {}
    recs = trob.run_robustness_sweep(cfg, n=60, data_fn=data_fn,
                                     verbose=False, device="cpu",
                                     models=trained)
    assert [r["model"] for r in recs] == list(cfg.models)
    for r in recs:
        assert "error" not in r and 0.0 <= r["accuracy"] <= 1.0, r
    model = trained[(0.3, "leap", 0)]
    X, y, _ = data_fn(60)
    data = trob.preprocess_ists(X[:8], 0.3, seed=0)
    batch = {"seq": torch.as_tensor(data["seq"]),
             "coeffs": torch.as_tensor(data["coeffs"]),
             "y": torch.as_tensor(y[:8].astype(np.int64))}
    model.eval()
    with torch.no_grad():
        gen = lambda: torch.Generator().manual_seed(1)
        loss, logits = trob.ists_loss(model, batch, gen(), kl_weight=0.5)
        aux = model(batch["seq"], batch["coeffs"], generator=gen(),
                    with_aux=True)[1]
        ce = trob.softmax_cross_entropy(logits, batch["y"])
    assert float(aux) > 0
    np.testing.assert_allclose(float(loss), float(ce + 0.5 * aux),
                               rtol=1e-6)
