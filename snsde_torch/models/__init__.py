from .ancde import ANCDE, EXIT, LEAP, NeuralRDE, hard_sigmoid_ste
from .attn import MIAMLayer, MIAMPipeline, SAnDLayer, dense_interpolation
from .flows import (CouplingFlowLayer, GRUFlowBlock, NeuralControlledFlow,
                    NeuralFlow, NeuralFlowCDE, NeuralMixture, ResNetFlowLayer,
                    TimeTanh)
from .latent_sde import LatentSDE
from .mtan import (DecRNN3, LatentClassifier, MTANClassifier, MTANDecoder,
                   MTANEncoder, MultiTimeAttention, TimeEmbedding)
from .neuralcde import (FinalTanh, GRUODEField, NeuralCDE, NeuralCDEStream,
                        SingleHiddenLayer, cde_solve_dispatch)
from .neuralsde import (NDEModel, NeuralSDE, NeuralSDEForecasting, NeuralSDEStream,
                        ReadoutHead, resolve_dt, solve_dispatch)
from .rnn import (GRUD, ODERNN, GRUdt, SeqCNN, SeqRNN, SeqTransformer,
                  last_observation_excl)
from .time_rnn import ODELSTM, PLSTM, TGLSTM, TLSTM, GRUDFull

__all__ = ["ANCDE", "EXIT", "LEAP", "NeuralRDE", "hard_sigmoid_ste",
           "MIAMLayer", "MIAMPipeline", "SAnDLayer", "dense_interpolation",
           "CouplingFlowLayer", "GRUFlowBlock", "NeuralControlledFlow",
           "NeuralFlow", "NeuralFlowCDE", "NeuralMixture", "ResNetFlowLayer",
           "TimeTanh", "DecRNN3", "LatentClassifier", "MTANClassifier",
           "MTANDecoder", "MTANEncoder", "MultiTimeAttention",
           "TimeEmbedding", "LatentSDE", "FinalTanh", "GRUODEField", "NeuralCDE",
           "NeuralCDEStream", "SingleHiddenLayer", "cde_solve_dispatch",
           "NDEModel", "NeuralSDE", "NeuralSDEForecasting", "NeuralSDEStream",
           "ReadoutHead", "resolve_dt", "solve_dispatch", "SeqRNN",
           "SeqCNN", "SeqTransformer", "last_observation_excl", "GRUDFull",
           "GRUdt", "GRUD", "ODERNN", "ODELSTM", "TLSTM", "PLSTM", "TGLSTM"]
