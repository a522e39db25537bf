from .neuralcde import (FinalTanh, GRUODEField, NeuralCDE, NeuralCDEStream,
                        SingleHiddenLayer, cde_solve_dispatch)
from .neuralsde import (NeuralSDE, NeuralSDEForecasting, ReadoutHead,
                        resolve_dt, solve_dispatch)

__all__ = ["FinalTanh", "GRUODEField", "NeuralCDE", "NeuralCDEStream",
           "SingleHiddenLayer", "cde_solve_dispatch", "NeuralSDE",
           "NeuralSDEForecasting", "ReadoutHead", "resolve_dt",
           "solve_dispatch"]
