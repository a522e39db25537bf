from .loop import (FitResult, TrainConfig, bce_with_logits,
                   bce_with_logits_per_sample, fit_classifier, make_loss_fn,
                   make_optimizer, readout_grad_hook, train_step,
                   weight_regularization)
from .metrics import (ClassificationMetrics, auroc, average_precision,
                      classification_metrics, confusion_matrix)
from .schedule import ReduceLROnPlateau

__all__ = ["FitResult", "TrainConfig", "bce_with_logits",
           "bce_with_logits_per_sample", "fit_classifier", "make_loss_fn",
           "make_optimizer", "readout_grad_hook", "train_step",
           "weight_regularization", "ClassificationMetrics", "auroc",
           "average_precision", "classification_metrics", "confusion_matrix",
           "ReduceLROnPlateau"]
