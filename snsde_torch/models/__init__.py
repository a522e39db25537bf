from .latent_sde import LatentSDE
from .neuralcde import (FinalTanh, GRUODEField, NeuralCDE, NeuralCDEStream,
                        SingleHiddenLayer, cde_solve_dispatch)
from .neuralsde import (NeuralSDE, NeuralSDEForecasting, NeuralSDEStream,
                        ReadoutHead, resolve_dt, solve_dispatch)
from .rnn import (GRUD, ODERNN, GRUdt, SeqCNN, SeqRNN, SeqTransformer,
                  last_observation_excl)
from .time_rnn import ODELSTM, PLSTM, TGLSTM, TLSTM, GRUDFull

__all__ = ["LatentSDE", "FinalTanh", "GRUODEField", "NeuralCDE",
           "NeuralCDEStream", "SingleHiddenLayer", "cde_solve_dispatch",
           "NeuralSDE", "NeuralSDEForecasting", "NeuralSDEStream",
           "ReadoutHead", "resolve_dt", "solve_dispatch", "SeqRNN",
           "SeqCNN", "SeqTransformer", "last_observation_excl", "GRUDFull",
           "GRUdt", "GRUD", "ODERNN", "ODELSTM", "TLSTM", "PLSTM", "TGLSTM"]
