from .brownian import BrownianGrid, brownian_increments, space_time_levy_area
from .interp import (CubicPath, fill_missing_linear, hermite_cubic_coeffs,
                     natural_cubic_coeffs, pack_coeffs, tridiagonal_solve,
                     unpack_coeffs)
from .solve import make_grid, sdeint

__all__ = ["BrownianGrid", "brownian_increments", "space_time_levy_area",
           "CubicPath", "fill_missing_linear", "hermite_cubic_coeffs",
           "natural_cubic_coeffs", "pack_coeffs", "tridiagonal_solve",
           "unpack_coeffs", "make_grid", "sdeint"]
