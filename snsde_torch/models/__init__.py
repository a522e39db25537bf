from .neuralsde import (NeuralSDE, NeuralSDEForecasting, ReadoutHead,
                        resolve_dt, solve_dispatch)

__all__ = ["NeuralSDE", "NeuralSDEForecasting", "ReadoutHead", "resolve_dt",
           "solve_dispatch"]
