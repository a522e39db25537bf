from .brownian import (BrownianGrid, VirtualBrownianTree, brownian_increments,
                       counter_normals, space_time_levy_area)
from .dopri import odeint_dopri5
from .extra_solvers import (odeint_ode23s, odeint_rk12, odeint_rk23,
                            odeint_sym12)
from .logsig import logsig_windows, logsignature_channels, lyndon_words
from .interp import (CubicPath, LinearPath, fill_missing_linear,
                     hermite_cubic_coeffs, linear_coeffs,
                     natural_cubic_coeffs, pack_coeffs, rectilinear_coeffs,
                     tridiagonal_solve, unpack_coeffs)
from .solve import (SOLVER_ORDERS, cdeint, make_grid, odeint, sdeint,
                    sdeint_adaptive)

__all__ = ["BrownianGrid", "VirtualBrownianTree", "brownian_increments",
           "counter_normals", "space_time_levy_area", "CubicPath",
           "LinearPath", "fill_missing_linear", "hermite_cubic_coeffs",
           "linear_coeffs", "natural_cubic_coeffs", "pack_coeffs",
           "rectilinear_coeffs", "tridiagonal_solve", "unpack_coeffs",
           "make_grid", "sdeint", "sdeint_adaptive", "odeint", "cdeint",
           "odeint_dopri5", "odeint_rk23", "odeint_rk12", "odeint_ode23s",
           "odeint_sym12", "SOLVER_ORDERS", "logsig_windows",
           "logsignature_channels", "lyndon_words"]
