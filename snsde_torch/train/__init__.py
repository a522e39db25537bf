from .loop import (FitResult, TrainConfig, bce_with_logits,
                   bce_with_logits_per_sample, clip_by_global_norm,
                   fit_classifier, softmax_cross_entropy,
                   softmax_cross_entropy_per_sample,
                   iterate_batches, make_loss_fn, make_optimizer,
                   readout_grad_hook, train_step, weight_regularization)
from .metrics import (ClassificationMetrics, auroc, average_precision,
                      classification_metrics, confusion_matrix)
from .schedule import ReduceLROnPlateau, StepLR

__all__ = ["FitResult", "TrainConfig", "bce_with_logits",
           "bce_with_logits_per_sample", "clip_by_global_norm",
           "fit_classifier", "softmax_cross_entropy",
           "softmax_cross_entropy_per_sample",
           "iterate_batches", "make_loss_fn",
           "make_optimizer", "readout_grad_hook", "train_step",
           "weight_regularization", "ClassificationMetrics", "auroc",
           "average_precision", "classification_metrics", "confusion_matrix",
           "ReduceLROnPlateau", "StepLR"]
