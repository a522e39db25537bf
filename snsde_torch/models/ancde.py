"""ANCDE, EXIT, LEAP and NeuralRDE (counterpart of snsde/models/ancde.py).

  * ANCDE: a bottom CDE (hidden = input channels) gives a per-step
    attention path; a hard-sigmoid straight-through binariser (or a soft
    sigmoid) gates the control, and a top CDE runs over the gated path
    a(t)⊙X(t), re-fit as Hermite coefficients (differentiably: the top
    solve's control-stream cotangent reaches the gate).
  * EXIT: an encoder CDE gives h0, then the coupled state [x̂ ‖ h ‖
    kinetic ‖ jac], dx̂ = f_ode(x̂) dt, dh = g(h) dx̂, with the kinetic
    energy and a Hutchinson estimate of the Jacobian's Frobenius norm
    accumulated in two channels (the eager `odeint`, as the JAX package
    runs it off its kernels).
  * LEAP: a mapping MLP transforms the control path, a CDE runs over the
    re-fit learned path, and the square of a Hutchinson divergence
    estimate of the mapping is returned as an auxiliary loss.
  * NeuralRDE: a CDE over the log-signature stream of windows of 4
    (ops.logsig), its grid on the host.

Every CDE solve goes through `cde_solve_dispatch`: the fused CDE kernels
on a CUDA device, the eager `cdeint` on the CPU. Both Hutchinson products
are of x ↦ (x +) W₂ tanh(W₁x + b₁) + b₂, whose Jacobian-vector product
has the closed form (ε +) W₂(sech²(W₁x + b₁) ⊙ W₁ε). The probe ε is drawn
from the caller's generator (the JAX package draws it from the step's
key), or from a generator seeded 0 on the model's device when none is
given, so a call stays deterministic as JAX's `PRNGKey(0)` default does;
`eps=` passes a probe in.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import make_linear
from ..ops.interp import CubicPath, hermite_cubic_coeffs
from ..ops.logsig import logsig_windows, logsignature_channels
from ..ops.solve import odeint
from .neuralcde import FinalTanh, cde_solve_dispatch
from .neuralsde import resolve_dt

__all__ = ["ANCDE", "EXIT", "LEAP", "NeuralRDE", "hard_sigmoid_ste",
           "path_on_knots", "probe"]


def hard_sigmoid_ste(x):
    """Hard sigmoid with straight-through rounding: forward round(clip(0.2x
    + 0.5, 0, 1)) (half to even, as jnp.round), backward the gradient of
    the clipped surrogate. The clip is jnp.clip's min(max(.)), which
    splits the gradient of a value on a bound in half (torch.clamp would
    pass it whole)."""
    soft = torch.minimum(torch.maximum(0.2 * x + 0.5, x.new_zeros(())),
                         x.new_ones(()))
    return soft + (torch.round(soft) - soft).detach()


def path_on_knots(path: CubicPath) -> torch.Tensor:
    """The path at each of its knot times -> [B, L, C]; a knot takes the
    segment on its left, as the JAX `evaluate` buckets it."""
    return path.evaluate_grid(path.times_np).movedim(0, 1)


def probe(shape, like: torch.Tensor,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A standard normal Hutchinson probe of `shape` on like's device,
    from `generator`, or from one seeded 0 when none is given."""
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(0)
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _tanh_mlp_jvp(lin1: nn.Linear, lin2: nn.Linear, x, eps):
    """(∂/∂x) lin2(tanh(lin1(x))) · eps in closed form."""
    a = torch.tanh(lin1(x))
    return ((1.0 - a * a) * (eps @ lin1.weight.T)) @ lin2.weight.T


class ANCDE(nn.Module):
    """forward(times [L], coeffs [B, L-1, 4C]) -> (linear(hn), hn [B, L,
    H])."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, soft: bool = True,
                 timewise: bool = True, hidden_hidden=None,
                 num_hidden_layers: int = 1, method: str = "rk4", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        hh = hidden_hidden or hidden_channels
        C = input_channels
        self.func_f = FinalTanh(C, C, hh, num_hidden_layers, **kw)
        self.func_g = FinalTanh(C, hidden_channels, hh, num_hidden_layers,
                                **kw)
        self.initial_network = make_linear(C, C, **kw)
        self.feature_extractor = make_linear(C, hidden_channels, **kw)
        self.linear = make_linear(hidden_channels, output_channels, **kw)
        self.time_attention = make_linear(C, 1, **kw)
        self.soft, self.timewise, self.method = soft, timewise, method

    def attention_path(self, times, coeffs, *, slope=None,
                       use_fused: bool = True):
        """The bottom-CDE gate a(t): in (0, 1) (soft) or {0, 1} (hard STE),
        [B, L, 1] (timewise) or [B, L, C]."""
        path = CubicPath(coeffs, times)
        z0 = self.initial_network(path.evaluate(path.times[0]))
        a_stream = cde_solve_dispatch(
            path, self.func_f, z0, times, dt=resolve_dt(times, floor=0.0),
            method=self.method, use_fused=use_fused).movedim(0, 1)
        att = self.time_attention(a_stream) if self.timewise else a_stream
        if self.soft:
            return torch.sigmoid(att)
        return hard_sigmoid_ste((1.0 if slope is None else slope) * att)

    def forward(self, times, coeffs, final_index=None, *, slope=None,
                use_fused: bool = True):
        path = CubicPath(coeffs, times)
        att = self.attention_path(times, coeffs, slope=slope,
                                  use_fused=use_fused)
        # the top CDE over the gated path Y(t) = a(t) ⊙ X(t)
        Y = att * path_on_knots(path)                    # [B, L, C]
        Y_path = CubicPath(hermite_cubic_coeffs(path.times, Y), times)
        z_t = cde_solve_dispatch(Y_path, self.func_g,
                                 self.feature_extractor(Y[:, 0]), times,
                                 dt=resolve_dt(times, floor=0.0),
                                 method=self.method, use_fused=use_fused)
        hn = z_t.movedim(0, 1)
        return self.linear(hn), hn


class EXIT(nn.Module):
    """forward(times, coeffs) -> (linear(hn), hn [B, L, H]), and the
    regulariser mean(kinetic + jac) at the last time as a third output
    with return_reg."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, hidden_hidden=None,
                 num_hidden_layers: int = 1, method: str = "rk4", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        hh = hidden_hidden or hidden_channels
        C, H = input_channels, hidden_channels
        self.enc_func = FinalTanh(C, H, hh, num_hidden_layers, **kw)
        self.ode_f1 = make_linear(C, hh, **kw)
        self.ode_f2 = make_linear(hh, C, **kw)
        self.dec_func = FinalTanh(C, H, hh, num_hidden_layers, **kw)
        self.initial_network = make_linear(C, H, **kw)
        self.embed_x = make_linear(H, C, **kw)
        self.linear = make_linear(H, output_channels, **kw)
        self.method = method

    def _f_ode(self, x):
        return self.ode_f2(torch.tanh(self.ode_f1(x)))

    def forward(self, times, coeffs, final_index=None, *,
                generator: Optional[torch.Generator] = None, eps=None,
                return_reg: bool = False, use_fused: bool = True):
        path = CubicPath(coeffs, times)
        dt = resolve_dt(times, floor=0.0)
        z0 = self.initial_network(path.evaluate(path.times[0]))
        h0 = cde_solve_dispatch(path, self.enc_func, z0, times, dt=dt,
                                method=self.method, use_fused=use_fused)[-1]
        x0 = self.embed_x(h0)
        C = x0.shape[-1]
        if eps is None:
            eps = probe(x0.shape, x0, generator)

        def joint_f(t, state):
            x_hat, h = state[..., :C], state[..., C:-2]
            dx = self._f_ode(x_hat)
            dh = torch.einsum("...hc,...c->...h", self.dec_func(t, h), dx)
            jv = _tanh_mlp_jvp(self.ode_f1, self.ode_f2, x_hat, eps)
            return torch.cat([dx, dh, (dx * dx).sum(-1, keepdim=True),
                              (jv * jv).sum(-1, keepdim=True)], dim=-1)

        state0 = torch.cat([x0, h0, x0.new_zeros((x0.shape[0], 2))], dim=-1)
        zs = odeint(joint_f, state0, times, dt=dt, method=self.method)
        hn = zs[..., C:-2].movedim(0, 1)                 # [B, L, H]
        out = self.linear(hn)
        if return_reg:
            return out, hn, (zs[-1, :, -2] + zs[-1, :, -1]).mean()
        return out, hn


class LEAP(nn.Module):
    """forward(times, coeffs) -> (linear(hn), hn [B, L, H], div_est²): the
    CDE over the mapped path x + mapping2(tanh(mapping1(x))), and the
    square of the Hutchinson estimate of the mapping's divergence."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, hidden_hidden=None,
                 num_hidden_layers: int = 1, method: str = "rk4", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        hh = hidden_hidden or hidden_channels
        C, H = input_channels, hidden_channels
        self.mapping1 = make_linear(C, hh, **kw)
        self.mapping2 = make_linear(hh, C, **kw)
        self.func = FinalTanh(C, H, hh, num_hidden_layers, **kw)
        self.initial_network = make_linear(C, H, **kw)
        self.linear = make_linear(H, output_channels, **kw)
        self.method = method

    def _map(self, x):
        return x + self.mapping2(torch.tanh(self.mapping1(x)))

    def forward(self, times, coeffs, final_index=None, *,
                generator: Optional[torch.Generator] = None, eps=None,
                use_fused: bool = True):
        path = CubicPath(coeffs, times)
        X_grid = path_on_knots(path)
        Z = self._map(X_grid)                            # the learned path
        Z_path = CubicPath(hermite_cubic_coeffs(path.times, Z), times)
        zs = cde_solve_dispatch(Z_path, self.func,
                                self.initial_network(Z[:, 0]), times,
                                dt=resolve_dt(times, floor=0.0),
                                method=self.method, use_fused=use_fused)
        hn = zs.movedim(0, 1)
        if eps is None:
            eps = probe(X_grid.shape, X_grid, generator)
        jv = eps + _tanh_mlp_jvp(self.mapping1, self.mapping2, X_grid, eps)
        div_est = (jv * eps).sum(-1).mean()
        return self.linear(hn), hn, div_est ** 2


class NeuralRDE(nn.Module):
    """forward(x_values [B, L, C] raw stream, times [L]) -> (linear(hn),
    hn [B, n_windows+1, H]): a CDE over the depth-`depth` log-signature
    stream of windows of `window` pieces."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, depth: int = 2, window: int = 4,
                 hidden_hidden=None, num_hidden_layers: int = 1,
                 method: str = "rk4", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        hh = hidden_hidden or hidden_channels
        sig = logsignature_channels(input_channels, depth)
        self.func = FinalTanh(sig, hidden_channels, hh, num_hidden_layers,
                              **kw)
        self.initial_network = make_linear(sig, hidden_channels, **kw)
        self.linear = make_linear(hidden_channels, output_channels, **kw)
        self.depth, self.window, self.method = depth, window, method

    def forward(self, x_values, times, final_index=None, *,
                use_fused: bool = True):
        t_np, feats = logsig_windows(x_values, self.depth, self.window,
                                     times=times)
        path = CubicPath(hermite_cubic_coeffs(
            torch.as_tensor(t_np, device=feats.device), feats), t_np)
        zs = cde_solve_dispatch(path, self.func,
                                self.initial_network(feats[:, 0]), t_np,
                                dt=resolve_dt(t_np, floor=0.0),
                                method=self.method, use_fused=use_fused)
        hn = zs.movedim(0, 1)                            # [B, n_w+1, H]
        return self.linear(hn), hn
