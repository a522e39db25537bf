"""mTAN: multi-time attention encoder and decoders for irregular series
(counterpart of snsde/models/mtan.py).

  * attention scores come from time embeddings alone (queries: the
    reference grid's times, keys: the observation times);
  * the per-channel observation mask is applied to each value channel, so
    each channel has its own masked softmax over the keys (-1e9 fill);
    written, as in JAX, as einsum, where and softmax: torch's
    scaled_dot_product_attention takes no per-channel mask;
  * the fixed sinusoidal embedding uses position 48 t and div =
    exp(arange(0, d, 2) * -(ln freq)/d).

The reference grid `query` is an `nn.Parameter`: the JAX package trains
every float leaf, the grid included (its gradient flows through
`time_emb(query)`). The bidirectional GRU of the encoder and the decoders
runs through the fused GRU kernels on a CUDA device, forward and
reverse=True, at every width they take, and so does the classifiers' GRU
(a `lax.scan` in JAX); the CPU takes the eager loop.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.layers import GRUCell, make_linear
from .rnn import SeqRNN

__all__ = ["TimeEmbedding", "MultiTimeAttention", "MTANEncoder",
           "MTANDecoder", "DecRNN3", "MTANClassifier", "LatentClassifier"]


class TimeEmbedding(nn.Module):
    """Learned (linear ‖ sin(periodic)) or fixed sinusoidal embedding:
    tt [..., L] -> [..., L, embed_time]."""

    def __init__(self, embed_time: int, learn_emb: bool = True,
                 freq: float = 10.0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.periodic = (make_linear(1, embed_time - 1, **kw) if learn_emb
                         else None)
        self.linear = make_linear(1, 1, **kw) if learn_emb else None
        self.embed_time, self.learn_emb, self.freq = (embed_time, learn_emb,
                                                      freq)

    def forward(self, tt):
        tt = tt[..., None]
        if self.learn_emb:
            return torch.cat([self.linear(tt),
                              torch.sin(self.periodic(tt))], dim=-1)
        d = self.embed_time
        div = torch.exp(torch.arange(0, d, 2, dtype=tt.dtype,
                                     device=tt.device)
                        * -(math.log(self.freq) / d))
        angles = 48.0 * tt * div                         # [..., L, d/2]
        pe = tt.new_zeros(tt.shape[:-1] + (d,))
        pe[..., 0::2] = torch.sin(angles)
        pe[..., 1::2] = torch.cos(angles[..., :d // 2])
        return pe


class MultiTimeAttention(nn.Module):
    """Time-embedding attention with per-channel masking."""

    def __init__(self, input_dim: int, nhidden: int = 16,
                 embed_time: int = 16, num_heads: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        assert embed_time % num_heads == 0
        kw = dict(generator=generator, device=device)
        self.wq = make_linear(embed_time, embed_time, **kw)
        self.wk = make_linear(embed_time, embed_time, **kw)
        self.wo = make_linear(input_dim * num_heads, nhidden, **kw)
        self.num_heads, self.embed_time = num_heads, embed_time

    def _scores(self, query, key):
        """[B, h, Lq, Lk]; an unbatched query grid [Lq, E] is broadcast
        over the batch."""
        h = self.num_heads
        dk = self.embed_time // h
        q = self.wq(query).reshape(query.shape[:-1] + (h, dk))
        k = self.wk(key).reshape(key.shape[:-1] + (h, dk))
        if q.ndim == 3:
            q = q.expand((key.shape[0],) + q.shape)
        return torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)

    def attention_weights(self, query, key, mask=None):
        """The distributions forward uses: [B, h, Lq, Lk] without a mask,
        rows summing to 1 over the keys; with a mask [B, Lk, D] one masked
        softmax a value channel, [B, h, Lq, Lk, D]."""
        scores = self._scores(query, key)
        if mask is None:
            return torch.softmax(scores, dim=-1)
        m = mask[:, None, None, :, :]                    # [B,1,1,Lk,D]
        return torch.softmax(torch.where(m == 0, -1e9, scores[..., None]),
                             dim=-2)

    def forward(self, query, key, value, mask=None):
        """query [(B,) Lq, E], key [B, Lk, E], value [B, Lk, D], mask
        [B, Lk, D] (1 = observed) -> [B, Lq, nhidden]."""
        B, Lk, D = value.shape
        scores = self._scores(query, key)[..., None]     # [B,h,Lq,Lk,1]
        if mask is not None:
            scores = torch.where(mask[:, None, None, :, :] == 0, -1e9,
                                 scores)
        else:
            scores = scores.expand(scores.shape[:-1] + (D,))
        p = torch.softmax(scores, dim=-2)                # over the keys
        out = (p * value[:, None, None, :, :]).sum(-2)   # [B, h, Lq, D]
        out = out.movedim(1, 2).reshape(B, -1, self.num_heads * D)
        return self.wo(out)


def _bigru(cell_f: GRUCell, cell_b: GRUCell, xs, use_fused: bool = True):
    """xs [L, B, C] -> [L, B, 2H]: the forward and the reverse recurrence,
    each through the fused GRU kernels on a CUDA device."""
    return torch.cat([SeqRNN._run(cell_f, xs, use_fused=use_fused),
                      SeqRNN._run(cell_b, xs, reverse=True,
                                  use_fused=use_fused)], dim=-1)


def _grid(query, device) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(query, dtype=torch.float32,
                                        device=device).clone())


class MTANEncoder(nn.Module):
    """enc_mtan_rnn: attention (observation times -> the reference grid)
    -> BiGRU -> MLP -> (mu ‖ logvar) at each reference point.
    forward(x [B, L, 2D] values ‖ mask, time_steps [B, L]) ->
    [B, Lq, 2 latent]."""

    def __init__(self, input_dim: int, query, latent_dim: int = 2,
                 nhidden: int = 16, embed_time: int = 16,
                 num_heads: int = 1, learn_emb: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.time_emb = TimeEmbedding(embed_time, learn_emb, **kw)
        self.att = MultiTimeAttention(2 * input_dim, nhidden, embed_time,
                                      num_heads, **kw)
        self.gru_f = GRUCell(nhidden, nhidden, **kw)
        self.gru_b = GRUCell(nhidden, nhidden, **kw)
        self.out1 = make_linear(2 * nhidden, 50, **kw)
        self.out2 = make_linear(50, latent_dim * 2, **kw)
        self.query = _grid(query, device)
        self.input_dim, self.latent_dim = input_dim, latent_dim

    def forward(self, x, time_steps, *, use_fused: bool = True):
        mask = x[:, :, self.input_dim:]
        out = self.att(self.time_emb(self.query), self.time_emb(time_steps),
                       x, torch.cat([mask, mask], dim=2))  # [B, Lq, nh]
        hs = _bigru(self.gru_f, self.gru_b, out.movedim(1, 0), use_fused)
        return self.out2(torch.relu(self.out1(hs.movedim(0, 1))))


class MTANDecoder(nn.Module):
    """dec_mtan_rnn: z on the reference grid -> BiGRU -> attention
    (reference grid -> observation times) -> MLP.
    forward(z [B, Lq, latent], time_steps [B, L]) -> [B, L, D]."""

    def __init__(self, input_dim: int, query, latent_dim: int = 2,
                 nhidden: int = 16, embed_time: int = 16,
                 num_heads: int = 1, learn_emb: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.time_emb = TimeEmbedding(embed_time, learn_emb, **kw)
        self.att = MultiTimeAttention(2 * nhidden, 2 * nhidden, embed_time,
                                      num_heads, **kw)
        self.gru_f = GRUCell(latent_dim, nhidden, **kw)
        self.gru_b = GRUCell(latent_dim, nhidden, **kw)
        self.out1 = make_linear(2 * nhidden, 50, **kw)
        self.out2 = make_linear(50, input_dim, **kw)
        self.query = _grid(query, device)
        self.input_dim = input_dim

    def forward(self, z, time_steps, *, use_fused: bool = True):
        out = _bigru(self.gru_f, self.gru_b, z.movedim(1, 0),
                     use_fused).movedim(0, 1)            # [B, Lq, 2nh]
        key_emb = self.time_emb(self.query)
        key_emb = key_emb.expand((z.shape[0],) + key_emb.shape)
        out = self.att(self.time_emb(time_steps), key_emb, out, None)
        return self.out2(torch.relu(self.out1(out)))


class DecRNN3(nn.Module):
    """dec_rnn3: BiGRU over the latent grid, then each target time read
    out at its reference index (searchsorted left, clipped).
    forward(z [B, Lq, latent], time_steps [B, L]) -> [B, L, D]."""

    def __init__(self, input_dim: int, query, latent_dim: int = 2,
                 nhidden: int = 16, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.gru_f = GRUCell(latent_dim, nhidden, **kw)
        self.gru_b = GRUCell(latent_dim, nhidden, **kw)
        self.out1 = make_linear(2 * nhidden, 50, **kw)
        self.out2 = make_linear(50, input_dim, **kw)
        self.query = _grid(query, device)
        self.input_dim = input_dim

    def forward(self, z, time_steps, *, use_fused: bool = True):
        out = _bigru(self.gru_f, self.gru_b, z.movedim(1, 0),
                     use_fused).movedim(0, 1)            # [B, Lq, 2nh]
        q = self.query.detach()
        idx = torch.searchsorted(q, time_steps.contiguous(), side="left")
        idx = idx.clamp(0, q.shape[0] - 1)               # [B, L]
        gathered = torch.gather(
            out, 1, idx[..., None].expand(-1, -1, out.shape[-1]))
        return self.out2(torch.relu(self.out1(gathered)))


def _gru_last(cell: GRUCell, xs, use_fused: bool):
    """The state after a forward GRU over xs [L, B, C] -> [B, H]."""
    return SeqRNN._run(cell, xs, use_fused=use_fused)[-1]


class _MLPHead(nn.Module):
    """relu(fc1) -> relu(fc2) -> fc3, the 300-300 head."""

    def _head(self, h):
        return self.fc3(torch.relu(self.fc2(torch.relu(self.fc1(h)))))


class MTANClassifier(_MLPHead):
    """enc_mtan_classif: attention over a learned reference grid -> GRU ->
    300-300 MLP. forward(x [B, L, 2D] values ‖ mask, time_steps [B, L]) ->
    logits [B, num_classes]."""

    def __init__(self, input_dim: int, query, nhidden: int = 16,
                 embed_time: int = 16, num_heads: int = 1,
                 num_classes: int = 2, learn_emb: bool = True,
                 freq: float = 10.0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.time_emb = TimeEmbedding(embed_time, learn_emb, freq, **kw)
        self.att = MultiTimeAttention(2 * input_dim, nhidden, embed_time,
                                      num_heads, **kw)
        self.gru = GRUCell(nhidden, nhidden, **kw)
        self.fc1 = make_linear(nhidden, 300, **kw)
        self.fc2 = make_linear(300, 300, **kw)
        self.fc3 = make_linear(300, num_classes, **kw)
        self.query = _grid(query, device)
        self.input_dim = input_dim

    def forward(self, x, time_steps, *, use_fused: bool = True):
        mask = x[:, :, self.input_dim:]
        out = self.att(self.time_emb(self.query), self.time_emb(time_steps),
                       x, torch.cat([mask, mask], dim=2))
        return self._head(_gru_last(self.gru, out.movedim(1, 0), use_fused))


class LatentClassifier(_MLPHead):
    """create_classifier: GRU over the latent grid -> 300-300 MLP.
    forward(z [B, L, latent]) -> logits [B, num_classes]."""

    def __init__(self, latent_dim: int, nhidden: int = 16,
                 num_classes: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.gru = GRUCell(latent_dim, nhidden, **kw)
        self.fc1 = make_linear(nhidden, 300, **kw)
        self.fc2 = make_linear(300, 300, **kw)
        self.fc3 = make_linear(300, num_classes, **kw)

    def forward(self, z, *, use_fused: bool = True):
        return self._head(_gru_last(self.gru, z.movedim(1, 0), use_fused))
