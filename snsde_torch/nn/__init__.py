from .layers import (BatchNorm, Dropout, GRUCell, Linear, LSTMCell, RNNCell,
                     make_linear)

__all__ = ["BatchNorm", "Dropout", "GRUCell", "Linear", "LSTMCell", "RNNCell",
           "make_linear"]
