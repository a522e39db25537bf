from .brownian import BrownianGrid, brownian_increments
from .interp import (CubicPath, fill_missing_linear, hermite_cubic_coeffs,
                     pack_coeffs, unpack_coeffs)
from .solve import make_grid, sdeint

__all__ = ["BrownianGrid", "brownian_increments", "CubicPath",
           "fill_missing_linear", "hermite_cubic_coeffs", "pack_coeffs",
           "unpack_coeffs", "make_grid", "sdeint"]
