from .classification import (HarnessConfig, InitialValueModel,
                             make_sde_model, parse_model_name, run_all,
                             run_sepsis, run_sepsis_ensemble, run_speech,
                             run_speech_ensemble)
from .forecasting import (ForecastConfig, make_forecast_model,
                          resolve_sde_method, run_mujoco)
from .robustness import (ISTSClassifier, SweepConfig, preprocess_ists,
                         run_robustness_sweep, train_ists_model)

__all__ = ["HarnessConfig", "InitialValueModel", "make_sde_model",
           "parse_model_name", "run_all", "run_sepsis",
           "run_sepsis_ensemble", "run_speech", "run_speech_ensemble",
           "ForecastConfig",
           "make_forecast_model", "resolve_sde_method", "run_mujoco",
           "ISTSClassifier", "SweepConfig", "preprocess_ists",
           "run_robustness_sweep", "train_ists_model"]
