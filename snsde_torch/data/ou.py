"""Ornstein–Uhlenbeck paths, the tutorial's data (counterpart of
snsde/data/ou.py): dX = theta (mu - X) dt + sigma dW by Euler, channels
(t, X), T=10 over N=20 points by default.

The standard normals come from an explicit `torch.Generator`, or from
`eps=` ([num_samples, N - 1], the JAX package's `jax.random.normal(key,
shape)` in a parity test): torch cannot replay JAX's RBG draws, so the
seam takes the noise in, as the models' probe noise does.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["generate_ou_paths", "ou_dataset"]


def generate_ou_paths(num_samples: int, T: float = 10.0, N: int = 20,
                      theta: float = 0.2, mu: float = 0.0,
                      sigma: float = 0.1, x0: float = 1.0, *,
                      generator: Optional[torch.Generator] = None,
                      eps=None, device=None):
    """(data [num_samples, N, 2] with channels (time, value), times [N] =
    linspace(0, 1, N)) in float32 on `device` (the generator's when none
    is given). The increments are sqrt(T/N) x `eps`, else x standard
    normals drawn from `generator`."""
    dt = T / N
    if eps is None:
        if generator is None:
            raise ValueError("generate_ou_paths needs generator= or eps=")
        dev = generator.device if device is None else torch.device(device)
        eps = torch.randn((num_samples, N - 1), generator=generator,
                          device=dev)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
    e = eps * torch.sqrt(torch.tensor(dt, dtype=torch.float32,
                                      device=eps.device))
    x = torch.full((num_samples,), float(x0), device=eps.device)
    xs = [x]
    for k in range(N - 1):
        x = x + theta * (mu - x) * dt + sigma * e[:, k]
        xs.append(x)
    X = torch.stack(xs, dim=1)                                 # [B, N]
    t_phys = torch.linspace(0.0, T, N, device=eps.device)
    data = torch.stack([t_phys.expand(num_samples, N), X], dim=-1)
    return data, torch.linspace(0.0, 1.0, N, device=eps.device)


def ou_dataset(num_samples: int = 1000, T: float = 10.0, N: int = 20,
               theta: float = 0.2, mu: float = 0.0, sigma: float = 0.1,
               x0: float = 1.0, train_ratio: float = 0.8, *,
               generator: torch.Generator, eps=None):
    """The tutorial pipeline: paths -> Hermite coefficients -> a random
    train/test split (a permutation from `generator` after the paths).
    Returns numpy arrays: train/test data and coefficients, and times."""
    from ..ops.interp import hermite_cubic_coeffs

    data, times = generate_ou_paths(num_samples, T, N, theta, mu, sigma, x0,
                                    generator=generator, eps=eps)
    coeffs = hermite_cubic_coeffs(times, data)
    n_train = int(num_samples * train_ratio)
    perm = torch.randperm(num_samples, generator=generator,
                          device=generator.device).to(data.device)
    tr, te = perm[:n_train], perm[n_train:]
    arr = lambda t: t.detach().cpu().numpy()
    return {"train_data": arr(data[tr]), "train_coeffs": arr(coeffs[tr]),
            "test_data": arr(data[te]), "test_coeffs": arr(coeffs[te]),
            "times": arr(times)}
