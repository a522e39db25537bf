"""Refusal of reverse mode through the adaptive solvers' non-differentiable
mode (counterpart of snsde/ops/_guards.py:37-73).

The JAX package's adaptive solvers (ops/dopri.py, ops/extra_solvers.py and
`sdeint_adaptive`) run a `lax.while_loop` unless told
`differentiable=True`, and a `while_loop` has no transpose rule, so JAX
refuses reverse mode through them with an actionable message. The port's
eager loops could be differentiated as they stand; they refuse it all the
same, so a loss that trains in the port trains in the JAX package too and
`differentiable=False` never quietly trains here where JAX raises.
"""

from __future__ import annotations

import torch

__all__ = ["nondiff_guard"]


class _Guard(torch.autograd.Function):
    """Identity going forward; the backward raises."""

    @staticmethod
    def forward(ctx, ys, message):
        ctx.message = message
        return ys.view_as(ys)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(ctx.message)


def nondiff_guard(ys: torch.Tensor, solver: str, hint: str) -> torch.Tensor:
    """`ys` unchanged, whose reverse-mode rule raises an error naming
    `solver` and the remedy `hint`."""
    return _Guard.apply(ys, (
        f"{solver} is not reverse-mode differentiable with "
        f"differentiable=False (the JAX package runs its adaptive step loop "
        f"as a lax.while_loop, which has no transpose rule, and the port "
        f"refuses it as JAX does). {hint}"))
