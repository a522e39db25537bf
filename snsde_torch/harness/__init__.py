from .classification import (HarnessConfig, InitialValueModel,
                             make_sde_model, parse_model_name, run_sepsis)

__all__ = ["HarnessConfig", "InitialValueModel", "make_sde_model",
           "parse_model_name", "run_sepsis"]
