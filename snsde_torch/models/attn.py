"""SAnD and MIAM attention models (counterpart of snsde/models/attn.py).

  * SAnD: a 1x1-conv input embedding, SAnD's positional encoding
    (sqrt(d)-scaled, per-pair sinusoid exponents), post-norm residual
    encoder blocks (multi-head attention, then the position-wise conv FFN
    d -> 2d -> d), dense interpolation onto `factor` pseudo-points, flatten,
    and the classification linear, whose vector is repeated over the
    sequence as the hidden stream; the out stream adds dropout and a
    linear embedding.
  * MIAM: observation, mask and delta embeddings with a time-descriptor
    positional encoding from the observation times, five encoding blocks
    of pre-norm cross-attention layers (the observation block one module,
    reused everywhere), the attention-distillation loop, the imputation
    branch with a decoder tied at initialisation to the observation
    embedding (its bias a parameter of its own), and the classification
    head, which the registry's layer does not use: its parameters stay and
    get zero gradients.

Dropout rates: SAnD 0.1; MIAM 0.2 on the attention weights and 0.1 in the
feed-forward, its residual dropouts 0. Masks come from the caller's
generator in training, and dropout is the identity without one. No kernel
runs here, as in the JAX package: plain torch operations on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.layers import BatchNorm, dropout, make_linear

__all__ = ["SAnDLayer", "MIAMLayer", "MIAMPipeline", "dense_interpolation",
           "sand_positional_encoding", "miam_time_descriptor_pe"]


# ---------------------------------------------------------------------------
# SAnD
# ---------------------------------------------------------------------------

def sand_positional_encoding(seq_len: int, d_model: int) -> np.ndarray:
    """SAnD's sinusoid table: for even i, pe[pos, i] = sin(pos /
    10000^(2i/d)), pe[pos, i+1] = cos(pos / 10000^(2(i+1)/d)) (per-pair
    exponents, unlike the vanilla transformer's), float32 numpy."""
    pe = np.zeros((seq_len, d_model), np.float32)
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    for i in range(0, d_model - 1, 2):
        pe[:, i] = np.sin(pos / (10000 ** ((2 * i) / d_model)))[:, 0]
        pe[:, i + 1] = np.cos(pos / (10000 ** ((2 * (i + 1)) / d_model)))[:, 0]
    if d_model % 2 == 1:
        pe[:, -1] = np.sin(pos / (10000 ** ((2 * (d_model - 1)) / d_model)))[:, 0]
    return pe


def dense_interpolation(x, factor: int):
    """SAnD dense interpolation: [B, L, H] -> [B, M, H] with w[m, t] =
    (1 - |s_t - (1+m)|/M)^2, s_t = M (t+1) / L."""
    L = x.shape[1]
    t = np.arange(1, L + 1, dtype=np.float32)
    m = np.arange(1, factor + 1, dtype=np.float32)
    s = factor * t / L
    w = (1.0 - np.abs(s[:, None] - m[None, :]) / factor) ** 2   # [L, M]
    return torch.einsum("blh,lm->bmh", x,
                        torch.as_tensor(w, dtype=x.dtype, device=x.device))


class _LayerNorm(nn.Module):
    """(x - mean) / sqrt(biased var + 1e-5), scaled by gamma, plus beta."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device))
        self.beta = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        return self.gamma * (x - mu) * torch.rsqrt(var + 1e-5) + self.beta


class _MHA(nn.Module):
    """Multi-head attention with q/k/v/out projections, an optional key
    mask (True = blocked, -1e9 fill) and dropout on the weights."""

    def __init__(self, d_model: int, num_heads: int,
                 attn_dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.wq, self.wk, self.wv, self.wo = (
            make_linear(d_model, d_model, **kw) for _ in range(4))
        self.num_heads = num_heads if d_model % num_heads == 0 else 1
        self.attn_dropout = attn_dropout

    def forward(self, q, k, v, mask=None, *, generator=None):
        B, Lq, H = q.shape
        Lk = k.shape[1]
        nh = self.num_heads
        hd = H // nh
        qh = self.wq(q).reshape(B, Lq, nh, hd).transpose(1, 2)
        kh = self.wk(k).reshape(B, Lk, nh, hd).transpose(1, 2)
        vh = self.wv(v).reshape(B, Lk, nh, hd).transpose(1, 2)
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd)
        if mask is not None:
            scores = torch.where(mask[:, None, :, :], -1e9, scores)
        attn = dropout(torch.softmax(scores, dim=-1), self.attn_dropout,
                       generator, self.training)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
        return self.wo(out.transpose(1, 2).reshape(B, Lq, H))


class _SAnDBlock(nn.Module):
    """Two post-norm residual sublayers: multi-head attention, then the
    position-wise conv FFN (1x1 convs: per-step Linears d -> 2d -> d)."""

    def __init__(self, d_model: int, num_heads: int, rate: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.attn = _MHA(d_model, num_heads, **kw)
        self.norm1 = _LayerNorm(d_model, device)
        self.conv1 = make_linear(d_model, 2 * d_model, **kw)
        self.conv2 = make_linear(2 * d_model, d_model, **kw)
        self.norm2 = _LayerNorm(d_model, device)
        self.rate = rate

    def forward(self, x, *, generator=None):
        drop = lambda a: dropout(a, self.rate, generator, self.training)
        x = self.norm1(x + drop(self.attn(x, x, x, generator=generator)))
        f = self.conv2(torch.relu(self.conv1(x)))
        return self.norm2(x + drop(f))


class SAnDLayer(nn.Module):
    """SAnD_layer: encoder -> dense interpolation -> flatten ->
    classification linear (the hidden vector, repeated over seq_len as hn),
    then out = embedding(dropout(hn)). forward(x [B, L, D]) -> (out, hn)
    [B, seq_len, hidden]. The classification linear starts from weight
    N(0, 0.02) and bias N(0, 1)."""

    def __init__(self, input_features: int, seq_len: int, hidden: int,
                 n_heads: int = 4, factor: int = 16, n_layers: int = 1,
                 rate: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        factor = min(factor, seq_len)
        self.input_embedding = make_linear(input_features, hidden, **kw)
        self.blocks = nn.ModuleList(_SAnDBlock(hidden, n_heads, rate, **kw)
                                    for _ in range(n_layers))
        self.clf = make_linear(factor * hidden, hidden, **kw)
        with torch.no_grad():
            nn.init.normal_(self.clf.weight, 0.0, 0.02, generator=generator)
            nn.init.normal_(self.clf.bias, 0.0, 1.0, generator=generator)
        self.embedding = make_linear(hidden, hidden, **kw)
        self.factor, self.seq_len, self.rate = factor, seq_len, rate

    def forward(self, x, *, generator: Optional[torch.Generator] = None):
        B, L, _ = x.shape
        h = self.input_embedding(x)                      # 1x1 conv embed
        d = h.shape[-1]
        h = math.sqrt(d) * h + torch.as_tensor(
            sand_positional_encoding(L, d), device=x.device)
        for blk in self.blocks:
            h = blk(h, generator=generator)
        v = self.clf(dense_interpolation(h, self.factor).reshape(B, -1))
        hn = v[:, None, :].expand(B, self.seq_len, v.shape[-1])
        out = self.embedding(dropout(hn, self.rate, generator,
                                     self.training))
        return out, hn


# ---------------------------------------------------------------------------
# MIAM
# ---------------------------------------------------------------------------

class _MIAMNorm(nn.Module):
    """alpha (x - mean) / (unbiased std + 1e-6) + bias (the eps added to
    the std, not the variance)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        n = x.shape[-1]
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True) * (n / max(n - 1, 1))
        return self.alpha * (x - mu) / (torch.sqrt(var) + 1e-6) + self.bias


class _MIAMEncoderLayer(nn.Module):
    """Pre-norm cross-attention: q += drop(attn(norm_q(q), norm_k(k),
    norm_k(k))), then q += drop(ff(norm_q_attn(q))); returns (q, k)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm_q = _MIAMNorm(d_model, device)
        self.norm_k = _MIAMNorm(d_model, device)
        self.norm_q_attn = _MIAMNorm(d_model, device)
        self.attn = _MHA(d_model, num_heads, attn_dropout=0.2, **kw)
        self.ff1 = make_linear(d_model, d_ff, **kw)
        self.ff2 = make_linear(d_ff, d_model, **kw)
        self.rate, self.ff_rate = 0.0, 0.1

    def forward(self, q, k, mask, *, generator=None):
        drop = lambda a, r: dropout(a, r, generator, self.training)
        kn = self.norm_k(k)
        q = q + drop(self.attn(self.norm_q(q), kn, kn, mask,
                               generator=generator), self.rate)
        ff = self.ff2(drop(torch.relu(self.ff1(self.norm_q_attn(q))),
                           self.ff_rate))
        return q + drop(ff, self.rate), k


class _EncodingBlock(nn.Module):
    """num_stack encoder layers and a final norm of the query stream."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 num_stack: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            _MIAMEncoderLayer(d_model, num_heads, d_ff, generator=generator,
                              device=device) for _ in range(num_stack))
        self.norm = _MIAMNorm(d_model, device)

    def forward(self, q, k, mask, *, generator=None):
        for layer in self.layers:
            q, k = layer(q, k, mask, generator=generator)
        return self.norm(q)


def miam_time_descriptor_pe(t, d_model: int, max_seq_len: int):
    """The sinusoid table of the observation times t [B, L]: pe[b, l, i] =
    sin (even i) or cos (odd i) of t[b, l] / max_seq_len^(2 (i//2) /
    d_model)."""
    i = np.arange(d_model)
    denom = np.power(float(max_seq_len), 2.0 * (i // 2) / d_model)
    ang = t[..., None] / torch.as_tensor(denom, dtype=t.dtype,
                                         device=t.device)
    even = torch.as_tensor(i % 2 == 0, device=t.device)
    return torch.where(even, torch.sin(ang), torch.cos(ang))


class MIAMPipeline(nn.Module):
    """The multi-duration pipeline with residual imputation. One
    `obs_block` module serves the initial observation encoding, every
    distillation iteration and both imputation calls."""

    def __init__(self, input_dim: int, d_model: int, max_length: int,
                 d_ff: Optional[int] = None, num_stack: int = 2,
                 num_heads: int = 1, n_iter: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d_ff = d_ff or d_model
        blk = lambda: _EncodingBlock(d_model, num_heads, d_ff, num_stack,
                                     **kw)
        self.obs_embed = make_linear(input_dim, d_model, **kw)
        self.mask_embed = make_linear(input_dim, d_model, **kw)
        self.deltas_embed = make_linear(input_dim, d_model, **kw)
        self.obs_block, self.mask_block, self.deltas_block = (
            blk(), blk(), blk())
        self.comb_block, self.missing_block = blk(), blk()
        # tied to the observation embedding at initialisation, then trained
        # on its own
        self.decoder = nn.Linear(d_model, input_dim, bias=False,
                                 device=device)
        with torch.no_grad():
            self.decoder.weight.copy_(self.obs_embed.weight.T)
        self.decoder_bias = nn.Parameter(torch.zeros(input_dim,
                                                     device=device))
        self.clf1 = make_linear(2 * d_model, d_model, **kw)
        self.clf_norm = BatchNorm(d_model, device=device)
        self.clf2 = make_linear(d_model, d_model, **kw)
        self.n_iter, self.max_seq_len = n_iter, max_length

    def forward(self, data, mask, times, deltas, attn_mask, *,
                generator=None):
        """data/mask/deltas [B, L, D], times [B, L], attn_mask [B, L] bool
        (True = a blocked key) -> (x_final, missing_comb_z, x_dd)."""
        B, L, _ = data.shape
        amask = attn_mask[:, None, :].expand(B, L, L)
        d_model = self.obs_embed.out_features
        pe = miam_time_descriptor_pe(times, d_model, self.max_seq_len)
        scale = math.sqrt(d_model)
        g = dict(generator=generator)

        x_z = self.obs_embed(data) * scale + pe
        m = self.mask_embed(mask) * scale + pe
        d = self.deltas_embed(deltas) * scale + pe
        x_z = self.obs_block(x_z, x_z, amask, **g)
        m = self.mask_block(m, m, amask, **g)
        d = self.deltas_block(d, d, amask, **g)
        missing_comb_z = self.missing_block(d, m, amask, **g)
        # attention distillation
        for _ in range(self.n_iter):
            comb_z = self.comb_block(missing_comb_z, x_z, amask, **g)
            x_z = self.obs_block(comb_z, x_z, amask, **g)
            missing_comb_z = self.missing_block(missing_comb_z,
                                                missing_comb_z, amask, **g)
        # the imputation branch
        x_mskd = self.obs_embed(data) * scale + pe
        x_d = self.obs_block(x_mskd, x_mskd, amask, **g)
        x_d = self.obs_block(x_z, x_d, amask, **g)
        x_final = x_d + x_z
        return (x_final, missing_comb_z,
                self.decoder(x_final) + self.decoder_bias)

    def classify(self, x_final, missing_comb_z):
        """The classification head: mean-pool both streams, concatenate,
        Linear -> BatchNorm -> tanh -> Linear -> sigmoid."""
        cat = torch.cat([x_final.mean(1), missing_comb_z.mean(1)], dim=-1)
        h = self.clf_norm(self.clf1(cat))
        return torch.sigmoid(self.clf2(torch.tanh(h)))


class MIAMLayer(nn.Module):
    """MIAM_layer: the pipeline's reconstruction x_dd mapped hidden ->
    dropout -> embedding to (out, hn). The attention mask blocks the keys
    whose first channel's delta is 0, the first step never.
    forward(x, mask, delta [B, L, D], seq_ts [B, L]) -> (out, hn)."""

    def __init__(self, input_dim: int, hidden: int, seq_len: int,
                 num_stack: int = 2, num_heads: int = 1, n_iter: int = 1,
                 n_layers: int = 1, rate: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        # n_layers is taken for the registry's signature; the stack depth
        # is num_stack
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.encoder = MIAMPipeline(input_dim, hidden, seq_len,
                                    num_stack=num_stack, num_heads=num_heads,
                                    n_iter=n_iter, **kw)
        self.hidden = make_linear(input_dim, hidden, **kw)
        self.embedding = make_linear(hidden, hidden, **kw)
        self.rate = rate

    def forward(self, x, mask, delta, seq_ts, *,
                generator: Optional[torch.Generator] = None):
        attn_mask = delta[..., 0] == 0.0
        attn_mask[:, 0] = False
        x_dd = self.encoder(x, mask, seq_ts, delta, attn_mask,
                            generator=generator)[2]
        hn = self.hidden(x_dd)
        return self.embedding(dropout(hn, self.rate, generator,
                                      self.training)), hn
