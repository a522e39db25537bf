from .common import (append_time_intensity, inject_missingness,
                     normalize_with_train_stats, preprocess_classification,
                     stratified_split)
from .mujoco import drop_timestep_rows, get_data, load_windows
from .synthetic import synthetic_mujoco, synthetic_sepsis

__all__ = ["append_time_intensity", "inject_missingness",
           "normalize_with_train_stats", "preprocess_classification",
           "stratified_split", "drop_timestep_rows", "get_data",
           "load_windows", "synthetic_mujoco", "synthetic_sepsis"]
