from .common import (append_time_intensity, cache_path, inject_missingness,
                     load_cached, normalize_with_train_stats,
                     preprocess_classification, save_cached,
                     stratified_split)
from . import (mujoco, person_activity, physionet2012, sepsis,
               speech_commands, uea)
from .mujoco import drop_timestep_rows, get_data, load_windows
from .native import get_lib as native_lib
from .ou import generate_ou_paths, ou_dataset
from .synthetic import (synthetic_mujoco, synthetic_sepsis,
                        synthetic_speech, synthetic_uea)

__all__ = ["mujoco", "person_activity", "physionet2012", "sepsis",
           "speech_commands", "uea", "append_time_intensity", "cache_path",
           "inject_missingness", "load_cached", "normalize_with_train_stats",
           "preprocess_classification", "save_cached", "stratified_split",
           "drop_timestep_rows", "get_data", "load_windows",
           "generate_ou_paths", "ou_dataset", "synthetic_mujoco",
           "synthetic_sepsis", "synthetic_speech", "synthetic_uea",
           "native_lib"]
