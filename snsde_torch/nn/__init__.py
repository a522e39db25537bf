from .layers import (ACTIVATIONS, MLP, BatchNorm, Dropout, GRUCell, Linear,
                     LSTMCell, RNNCell, lipswish, make_linear)

__all__ = ["ACTIVATIONS", "MLP", "BatchNorm", "Dropout", "GRUCell", "Linear",
           "LSTMCell", "RNNCell", "lipswish", "make_linear"]
