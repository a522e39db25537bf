from .classification import (HarnessConfig, InitialValueModel,
                             make_sde_model, parse_model_name, run_sepsis)
from .forecasting import (ForecastConfig, make_forecast_model,
                          resolve_sde_method, run_mujoco)

__all__ = ["HarnessConfig", "InitialValueModel", "make_sde_model",
           "parse_model_name", "run_sepsis", "ForecastConfig",
           "make_forecast_model", "resolve_sde_method", "run_mujoco"]
