from .common import (append_time_intensity, normalize_with_train_stats,
                     preprocess_classification, stratified_split)
from .synthetic import synthetic_sepsis

__all__ = ["append_time_intensity", "normalize_with_train_stats",
           "preprocess_classification", "stratified_split",
           "synthetic_sepsis"]
