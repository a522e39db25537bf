from .layers import BatchNorm, Dropout, Linear, make_linear

__all__ = ["BatchNorm", "Dropout", "Linear", "make_linear"]
