"""Interpolation harness: the mTAN-style VAE with an SDE encoder, trained by
the importance-weighted bound (counterpart of
snsde/harness/interpolation.py).

  * the observations, subsampled at `sample_tp`, are scattered onto a
    `num_ref_points` reference grid at bucket round(tp Lref) - 1;
  * Hermite coefficients over [t ‖ X] on that grid feed a NeuralSDEStream
    (Euler–Maruyama: the fused EM kernels on a CUDA device), whose whole
    trajectory goes through a linear head to (mu, logvar) a reference
    point;
  * k_iwae reparameterised draws are decoded at the observation times
    (MTANDecoder or DecRNN3, their BiGRU on the fused GRU kernels);
  * the loss is -(logsumexp_k(logpx - kl_coef KL) - log k) with a
    fixed-std Gaussian likelihood on the observed entries and the
    analytic KL to N(0, 1), KL annealed as 1 - 0.99^(itr - 10);
  * the test metric is the masked MSE of the decoder's mean prediction.

Where torch and the JAX package differ, the port decides as follows:
  * repeated buckets: the source with the highest position in a bucket
    wins, on every device (`scatter_to_ref`). JAX's `.at[].set` lets the
    later source win on the CPU; torch leaves the winner undefined and
    nondeterministic on CUDA. On every grid the flagship uses, t = 0 and
    t = 1/(L - 1) share bucket 0, so the t = 0 observation is overwritten
    by the second point's (masked, when that point is unobserved): a
    known fault of the reference, kept;
  * randomness: each iteration draws the keep mask, the Brownian
    increments and the samples from a generator seeded by a fixed
    function of (seed, itr) (`iteration_generator`), and the batch order
    from numpy's default_rng([seed, itr]), so a resumed run reproduces
    the uninterrupted one; the test set is evaluated with (seed,
    niters + 1);
  * the stream's own `linear` lies on no path; its gradient is zero-filled
    and Adam leaves it where it is, as optax does.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..fields import DiffusionField
from ..models.mtan import DecRNN3, MTANDecoder
from ..models.neuralsde import NeuralSDEStream
from ..nn.layers import make_linear
from ..ops.brownian import BrownianGrid
from ..ops.interp import hermite_cubic_coeffs
from ..train.checkpoint import latest_step, load_checkpoint, save_checkpoint
from ..train.loop import _to_device, padded_index_grid
from ..train.schedule import CosineAnnealingLR
from .classification import parse_model_name

__all__ = ["InterpolationConfig", "run_interpolation", "synthetic_physionet",
           "VAE", "build_interpolation_model", "scatter_to_ref",
           "encoder_control", "elbo_loss", "kl_coefficient",
           "iteration_generator"]


def synthetic_physionet(n: int = 1024, length: int = 64, dim: int = 12,
                        observe_rate: float = 0.35, seed: int = 0):
    """PhysioNet-2012-shaped data: values on a union grid with sparse
    observation masks -> (data [n, L, D], mask [n, L, D], tp [n, L]), the
    JAX package's numpy draws."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length, dtype=np.float32)
    freqs = rng.uniform(0.5, 3.0, (n, dim)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (n, dim)).astype(np.float32)
    vals = 0.5 + 0.4 * np.sin(
        2 * np.pi * freqs[:, None, :] * t[None, :, None] + phases[:, None, :]
    )
    vals += 0.02 * rng.normal(size=vals.shape)
    mask = (rng.random((n, length, dim)) < observe_rate).astype(np.float32)
    mask[:, 0, 0] = 1.0          # at least one observation a sample
    data = (vals * mask).astype(np.float32)
    tp = np.broadcast_to(t, (n, length)).copy()
    return data, mask, tp


@dataclass
class InterpolationConfig:
    enc: str = "neuralsde_0_18"
    dec: str = "mtan_rnn"            # mtan_rnn | rnn3
    latent_dim: int = 16
    rec_hidden: int = 32
    rec_num_hidden: int = 1
    gen_hidden: int = 50
    num_ref_points: int = 64
    k_iwae: int = 5
    std: float = 0.01
    niters: int = 100
    lr: float = 1e-3
    batch_size: int = 64
    sample_tp: float = 0.5
    use_kl: bool = True
    seed: int = 0
    verbose: bool = True
    save_dir: Optional[str] = None       # a checkpoint every 20 iterations
    resume: bool = False


class _Recognition(nn.Module):
    """SDE stream encoder + linear head -> (mu ‖ logvar) a reference
    point: forward(times_ref [Lref], coeffs [B, Lref-1, 4(D+1)]) ->
    [B, Lref, 2 latent]."""

    def __init__(self, enc_name: str, input_dim: int, hidden: int,
                 latent_dim: int, num_hidden: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        io, no = parse_model_name(enc_name)
        kw = dict(generator=generator, device=device)
        field = DiffusionField(input_dim + 1, hidden, hidden, num_hidden,
                               input_option=io, noise_option=no, **kw)
        self.sde = NeuralSDEStream(field, input_dim + 1, hidden, hidden,
                                   method="euler", **kw)
        self.head = make_linear(hidden, 2 * latent_dim, **kw)

    def forward(self, times_ref, coeffs, *,
                generator: Optional[torch.Generator] = None,
                bm: Optional[BrownianGrid] = None, use_fused: bool = True):
        _, stream = self.sde(times_ref, coeffs, generator=generator, bm=bm,
                             use_fused=use_fused)
        return self.head(stream)


class VAE(nn.Module):
    """The recognition network `rec` and the decoder `dec`."""

    def __init__(self, rec: _Recognition, dec: nn.Module):
        super().__init__()
        self.rec, self.dec = rec, dec


def reference_times(num_ref: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, num_ref, dtype=np.float32)


def build_interpolation_model(cfg: InterpolationConfig, input_dim: int,
                              device) -> VAE:
    """The VAE, drawn on the CPU from a generator seeded with cfg.seed (the
    same weights on every device), then moved to `device`."""
    gen = torch.Generator().manual_seed(cfg.seed)
    rec = _Recognition(cfg.enc, input_dim, cfg.rec_hidden, cfg.latent_dim,
                       cfg.rec_num_hidden, generator=gen)
    query = reference_times(cfg.num_ref_points)
    if cfg.dec == "mtan_rnn":
        dec = MTANDecoder(input_dim, query, cfg.latent_dim, cfg.gen_hidden,
                          embed_time=128, learn_emb=True, generator=gen)
    else:
        dec = DecRNN3(input_dim, query, cfg.latent_dim, cfg.gen_hidden,
                      generator=gen)
    return VAE(rec, dec).to(device)


def _gaussian_logpdf(x, mean, std: float):
    c = -0.5 * math.log(2 * math.pi)
    return c - math.log(std) - 0.5 * ((x - mean) / std) ** 2


def scatter_to_ref(x, m, tp, num_ref: int, sample_tp: float, *,
                   generator: Optional[torch.Generator] = None, keep=None):
    """Subsample the observed entries (keep ~ Bernoulli(sample_tp) from
    `generator`, or the given `keep` [B, L, D]; no subsampling at a rate
    of 1) and scatter them onto the reference grid at bucket
    clip(round(tp num_ref) - 1, 0, num_ref - 1). A bucket that several
    sources hit takes the one at the highest position; a bucket none hits
    is 0. x, m [B, L, D], tp [B, L] -> (fx, fm) [B, num_ref, D]."""
    if keep is None and sample_tp and sample_tp < 1.0:
        keep = torch.rand(m.shape, generator=generator, device=m.device) \
            < sample_tp
    m_sub = m if keep is None else m * keep.to(m.dtype)
    x_sub = x * m_sub
    B, L, D = x.shape
    idx = (torch.round(tp * num_ref).long() - 1).clamp(0, num_ref - 1)
    pos = torch.arange(L, device=x.device).expand(B, L)
    win = torch.full((B, num_ref), -1, dtype=torch.long, device=x.device)
    win = win.scatter_reduce(1, idx, pos, reduce="amax")
    hit = (win >= 0)[..., None]
    src = win.clamp_min(0)[..., None].expand(-1, -1, D)
    zero = x.new_zeros(())
    return (torch.where(hit, torch.gather(x_sub, 1, src), zero),
            torch.where(hit, torch.gather(m_sub, 1, src), zero))


def encoder_control(x, m, tp, num_ref: int, sample_tp: float, *,
                    generator: Optional[torch.Generator] = None, keep=None):
    """The encoder's control: the subsampled observations on the reference
    grid (scatter_to_ref) and the Hermite coefficients over [t ‖ fx] there
    -> (times_ref [num_ref] on the host, coeffs [B, num_ref-1, 4(D+1)])."""
    fx, _ = scatter_to_ref(x, m, tp, num_ref, sample_tp, generator=generator,
                           keep=keep)
    times_ref = reference_times(num_ref)
    t = torch.as_tensor(times_ref, dtype=x.dtype, device=x.device)
    vals = torch.cat([t[None, :, None].expand(x.shape[0], num_ref, 1), fx],
                     dim=-1)
    return times_ref, hermite_cubic_coeffs(t, vals)


def elbo_loss(model: VAE, batch: Dict[str, torch.Tensor],
              cfg: InterpolationConfig, kl_coef, smask=None, *,
              generator: Optional[torch.Generator] = None, keep=None,
              bm: Optional[BrownianGrid] = None, eps=None,
              use_fused: bool = True):
    """The IWAE loss of one batch (x, m [B, L, D], tp [B, L]) with the
    padded rows masked out by `smask` [B] -> (loss, (logpx, kl, mse_num,
    mse_den)): the valid rows' mean logpx over the k samples and KL, and
    the masked-MSE numerator and denominator as sums, so that padded
    batches aggregate exactly. The keep mask, the Brownian increments and
    the samples come from `generator` in that order, or from the `keep`,
    `bm` (an injected grid takes the eager solver) and `eps`
    [k, B, Lref, latent] seams."""
    x, m, tp = batch["x"], batch["m"], batch["tp"]
    Bc, lat = x.shape[0], cfg.latent_dim
    if smask is None:
        smask = x.new_ones((Bc,))
    times_ref, coeffs = encoder_control(x, m, tp, cfg.num_ref_points,
                                        cfg.sample_tp, generator=generator,
                                        keep=keep)
    out = model.rec(times_ref, coeffs, generator=generator, bm=bm,
                    use_fused=use_fused)                # [B, Lref, 2 lat]
    qz_mean, qz_logvar = out[..., :lat], out[..., lat:]
    if eps is None:
        eps = torch.randn((cfg.k_iwae,) + qz_mean.shape, generator=generator,
                          dtype=qz_mean.dtype, device=qz_mean.device)
    z0 = qz_mean[None] + eps * torch.exp(0.5 * qz_logvar[None])
    pred = model.dec(z0.reshape((-1,) + z0.shape[2:]),
                     tp.repeat(cfg.k_iwae, 1), use_fused=use_fused)
    pred = pred.reshape((cfg.k_iwae, Bc) + pred.shape[1:])   # [k, B, L, D]
    logpx = (_gaussian_logpdf(x[None], pred, cfg.std) * m[None]).sum(
        dim=(-1, -2))                                   # [k, B]
    kl = 0.5 * (torch.exp(qz_logvar) + qz_mean ** 2 - 1.0
                - qz_logvar).sum(dim=(-1, -2))          # [B]
    iwae = torch.logsumexp(logpx - kl_coef * kl[None], dim=0) \
        - math.log(cfg.k_iwae)
    nvalid = smask.sum().clamp_min(1.0)
    loss = -(iwae * smask).sum() / nvalid
    obs_w = m * smask[:, None, None]
    mse_num = ((pred.mean(dim=0) - x) ** 2 * obs_w).sum()
    return loss, ((logpx.mean(dim=0) * smask).sum() / nvalid,
                  (kl * smask).sum() / nvalid, mse_num, obs_w.sum())


def kl_coefficient(itr: int, use_kl: bool = True) -> float:
    """The KL weight of iteration itr: 0 before iteration 10, then
    1 - 0.99^(itr - 10); 1 without annealing."""
    if not use_kl:
        return 1.0
    return 0.0 if itr < 10 else 1 - 0.99 ** (itr - 10)


def iteration_generator(seed: int, itr: int, device) -> torch.Generator:
    """A generator on `device` seeded with the first 64-bit word of numpy's
    SeedSequence([seed, itr]): the draws of an iteration depend on nothing
    else."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, itr]).generate_state(
        1, np.uint64)[0]))
    return g


def run_interpolation(cfg: InterpolationConfig = InterpolationConfig(),
                      n: int = 1024,
                      data_fn: Callable = synthetic_physionet,
                      device=None) -> Dict:
    """Train the VAE for cfg.niters iterations (an epoch of the first 80%
    of data_fn(n=n, seed=cfg.seed) each) and evaluate the masked MSE on
    the rest. Adam with its rate set before each iteration from
    CosineAnnealingLR(lr, t_max=10, eta_min=1e-5); with cfg.save_dir a
    checkpoint every 20 iterations, and with cfg.resume the run continues
    from the latest one, the schedule re-advanced. Runs on CUDA unless
    `device` says otherwise. Returns {"model", "history" (iter, elbo,
    logpx, kl, kl_coef an iteration), "test_mse", "wall_time"}."""
    dev = resolve_device(device)
    data, mask, tp = data_fn(n=n, seed=cfg.seed)
    B_total, _, D = data.shape
    n_tr = int(0.8 * B_total)
    dtrain = _to_device({"x": data[:n_tr], "m": mask[:n_tr],
                         "tp": tp[:n_tr]}, dev)
    dtest = _to_device({"x": data[n_tr:], "m": mask[n_tr:],
                        "tp": tp[n_tr:]}, dev)
    model = build_interpolation_model(cfg, D, dev)
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.Adam(params, lr=cfg.lr)

    def batches(ddata, perm, smasks):
        for idx, sm in zip(perm, smasks):
            it = torch.as_tensor(idx, dtype=torch.long, device=dev)
            yield ({k: v[it] for k, v in ddata.items()},
                   torch.as_tensor(sm, device=dev))

    sched = CosineAnnealingLR(lr=cfg.lr, t_max=10, eta_min=1e-5)
    lr = cfg.lr
    history = []
    start_itr = 1
    if cfg.save_dir and cfg.resume and latest_step(cfg.save_dir) is not None:
        _, step0 = load_checkpoint(cfg.save_dir, {"model": model,
                                                  "opt_state": optimizer})
        start_itr = step0 + 1
        for _ in range(start_itr - 1):
            lr = sched.step()
    t_start = time.time()
    model.train()
    for itr in range(start_itr, cfg.niters + 1):
        rng = np.random.default_rng([cfg.seed, itr])
        gen = iteration_generator(cfg.seed, itr, dev)
        kl_coef = kl_coefficient(itr, cfg.use_kl)
        perm, smasks, _ = padded_index_grid(rng.permutation(n_tr),
                                            cfg.batch_size)
        for group in optimizer.param_groups:
            group["lr"] = lr
        outs = []
        for batch, smask in batches(dtrain, perm, smasks):
            optimizer.zero_grad(set_to_none=True)
            loss, (logpx, kl, _, _) = elbo_loss(model, batch, cfg, kl_coef,
                                                smask, generator=gen)
            loss.backward()
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            optimizer.step()
            outs.append(torch.stack([loss, logpx, kl]).detach())
        losses, logpxs, kls = torch.stack(outs).T.cpu().numpy()
        nvs = smasks.sum(axis=1)
        tot = float((losses * nvs).sum())
        totn = float(nvs.sum())
        lr = sched.step()
        history.append({"iter": itr, "elbo": -tot / totn,
                        "logpx": float((logpxs * nvs).sum() / totn),
                        "kl": float((kls * nvs).sum() / totn),
                        "kl_coef": kl_coef})
        if cfg.save_dir and itr % 20 == 0:
            save_checkpoint(cfg.save_dir, itr, model=model,
                            opt_state=optimizer)
        if cfg.verbose and itr % 10 == 0:
            print(f"iter {itr}: avg loss {tot / totn:.4f} kl_coef "
                  f"{kl_coef:.3f} [{time.time() - t_start:.0f}s]",
                  flush=True)

    perm, smasks, _ = padded_index_grid(np.arange(B_total - n_tr),
                                        cfg.batch_size)
    gen = iteration_generator(cfg.seed, cfg.niters + 1, dev)
    num = den = 0.0
    with torch.no_grad():
        for batch, smask in batches(dtest, perm, smasks):
            _, (_, _, bnum, bden) = elbo_loss(model, batch, cfg, 1.0, smask,
                                              generator=gen)
            num, den = num + bnum, den + bden
    return {"model": model, "history": history,
            "test_mse": float(num) / max(float(den), 1.0),
            "wall_time": time.time() - t_start}
