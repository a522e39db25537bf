from .activity import ActivityConfig, ActivityResult, run_activity
from .classification import (HarnessConfig, InitialValueModel, make_model,
                             make_sde_model, parse_model_name, run_all,
                             run_sepsis, run_sepsis_ensemble, run_speech,
                             run_speech_ensemble)
from .forecasting import (ForecastConfig, make_forecast_model,
                          resolve_sde_method, run_mujoco)
from .interpolation import (InterpolationConfig, run_interpolation,
                            synthetic_physionet)
from .param_search import SearchSpace, asha_search
from .robustness import (ISTSClassifier, SweepConfig, make_fixed_splits,
                         preprocess_ists, run_robustness_sweep,
                         train_ists_model)

__all__ = ["ActivityConfig", "ActivityResult", "run_activity",
           "HarnessConfig", "InitialValueModel", "make_model",
           "make_sde_model", "parse_model_name", "run_all", "run_sepsis",
           "run_sepsis_ensemble", "run_speech", "run_speech_ensemble",
           "ForecastConfig",
           "make_forecast_model", "resolve_sde_method", "run_mujoco",
           "InterpolationConfig", "run_interpolation", "synthetic_physionet",
           "SearchSpace", "asha_search",
           "ISTSClassifier", "SweepConfig", "make_fixed_splits",
           "preprocess_ists", "run_robustness_sweep", "train_ists_model"]
