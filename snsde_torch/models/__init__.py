from .neuralsde import NeuralSDE, ReadoutHead, resolve_dt, solve_dispatch

__all__ = ["NeuralSDE", "ReadoutHead", "resolve_dt", "solve_dispatch"]
