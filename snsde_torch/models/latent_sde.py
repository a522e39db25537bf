"""Latent SDE with the Girsanov KL (counterpart of
snsde/models/latent_sde.py:33-183, the reference's torch-ists
diff_module/NSDE/latent_sde.py:31-155).

A posterior drift f (an MLP on sin t, cos t and the latent state), a
constant diffusion g = sigma on every latent lane, and an OU prior drift
h = theta (mu - y). The KL rate rides the solve in one more lane, the
augmented system

    f_aug = [f, 0.5 ||(f - h) / g||^2],   g_aug = [g, 0],

and the total KL is KL(q(y0) || p(y0)) + the KL lane at the last time. The
forward returns (out, latent, logqp) as the reference's does.

theta, mu, sigma and the prior's py0_mean and py0_logvar are buffers (not
trained, no gradient); the posterior's qy0_mean and qy0_logvar are
parameters. On CUDA an Euler–Maruyama solve without an injected Brownian
grid runs the latent mode of the fused EM kernels
(`kernels/fused_em.fused_latent_em_solve`); the CPU, srk (no kernel takes
the latent system with it, in the JAX package either) and an injected grid
take the eager `sdeint(f_aug, g_aug)`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..kernels.fused_em import fused_latent_em_solve
from ..nn.layers import make_linear
from ..ops.brownian import BrownianGrid
from ..ops.interp import CubicPath
from ..ops.solve import sdeint
from .neuralsde import resolve_dt

__all__ = ["LatentSDE", "latent_solve_dispatch"]


def _stable_division(a, b, eps: float = 1e-7):
    b = torch.where(b.abs() > eps, b,
                    torch.sign(b) * eps + (b == 0).to(b.dtype) * eps)
    return a / b


def latent_solve_dispatch(model, times, aug0, *, generator, dt, method,
                          bm: Optional[BrownianGrid] = None,
                          use_fused: bool = True) -> torch.Tensor:
    """ys [T, B, H] of the augmented system: the fused EM kernels' latent
    mode for a euler solve of CUDA tensors without an injected `bm`, else
    the eager sdeint(f_aug, g_aug) on the same device."""
    if (use_fused and bm is None and method == "euler"
            and aug0.device.type == "cuda"):
        return fused_latent_em_solve(model, times, aug0, generator=generator,
                                     dt=dt)
    return sdeint(model.f_aug, model.g_aug, aug0, times, generator=generator,
                  bm=bm, dt=dt, method=method)


class LatentSDE(nn.Module):
    """forward(coeffs [B, L-1, 4C], times [L]) -> (out [B, L, H], latent
    [B, L, H-1], logqp scalar). H = hidden_channels is the augmented width:
    H - 1 latent lanes and the KL lane."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 hidden_hidden_channels: int, num_hidden_layers: int,
                 theta: float = 1.0, mu: float = 0.0, sigma: float = 0.5,
                 method: str = "srk", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        H, HH = hidden_channels, hidden_hidden_channels
        logvar = math.log(sigma ** 2 / (2.0 * theta))
        full = lambda v: torch.full((1, 1), v, dtype=torch.float32,
                                    device=device)
        self.register_buffer("theta", full(theta))
        self.register_buffer("mu", full(mu))
        self.register_buffer("sigma", full(sigma))
        self.register_buffer("py0_mean", full(mu))
        self.register_buffer("py0_logvar", full(logvar))
        self.qy0_mean = nn.Parameter(full(mu))
        self.qy0_logvar = nn.Parameter(full(logvar))
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        self.initial_network = lin(input_channels, H - 1)
        self.linear_in = lin(H - 1 + 2, HH)
        self.linears = nn.ModuleList(lin(HH, HH)
                                     for _ in range(num_hidden_layers - 1))
        self.linear_out = lin(HH, H - 1)
        self.embedding = lin(H - 1, H)
        self.method = method

    def f(self, t, y):
        """The posterior drift on the latent state y [..., H-1]."""
        t = torch.as_tensor(t, dtype=y.dtype, device=y.device).expand(
            y.shape[:-1] + (1,))
        z = torch.relu(self.linear_in(torch.cat([torch.sin(t), torch.cos(t),
                                                 y], dim=-1)))
        for lin in self.linears:
            z = torch.relu(lin(z))
        return self.linear_out(z)

    def g(self, t, y):
        """The shared diffusion sigma on every latent lane."""
        return self.sigma[0, 0].expand(y.shape)

    def h(self, t, y):
        """The OU prior drift theta (mu - y)."""
        return self.theta[0, 0] * (self.mu[0, 0] - y)

    def f_aug(self, t, y):
        """[f, the KL rate 0.5 ||(f - h) / g||^2] on the augmented state."""
        state = y[..., :-1]
        f = self.f(t, state)
        u = _stable_division(f - self.h(t, state), self.g(t, state))
        return torch.cat([f, 0.5 * (u * u).sum(-1, keepdim=True)], dim=-1)

    def g_aug(self, t, y):
        """[g, 0]: the KL lane has no noise."""
        state = y[..., :-1]
        return torch.cat([self.g(t, state),
                          state.new_zeros(state.shape[:-1] + (1,))], dim=-1)

    def kl_initial(self):
        """KL(q(y0) || p(y0)) of the scalar Gaussians."""
        q_m, q_lv = self.qy0_mean[0, 0], self.qy0_logvar[0, 0]
        p_m, p_lv = self.py0_mean[0, 0], self.py0_logvar[0, 0]
        return 0.5 * (p_lv - q_lv + (torch.exp(q_lv) + (q_m - p_m) ** 2)
                      / torch.exp(p_lv) - 1.0)

    def forward(self, coeffs, times, *,
                generator: Optional[torch.Generator] = None,
                dt: Optional[float] = None, method: Optional[str] = None,
                bm: Optional[BrownianGrid] = None, use_fused: bool = True):
        path = CubicPath(coeffs, times)
        z0 = self.initial_network(path.evaluate(path.times[0]))
        aug0 = torch.cat([z0, z0.new_zeros((z0.shape[0], 1))], dim=-1)
        dt = resolve_dt(times) if dt is None else dt
        ys = latent_solve_dispatch(self, times, aug0, generator=generator,
                                   dt=dt, method=method or self.method,
                                   bm=bm, use_fused=use_fused)
        ys = ys.movedim(0, 1)                                # [B, L, H]
        latent = ys[..., :-1]
        logqp = (self.kl_initial() + ys[:, -1, -1]).mean()
        return self.embedding(latent), latent, logqp
