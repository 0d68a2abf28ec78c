"""Evaluation and serving: AUC, the streamed eval pass with HoME's
BatchNorm recalibration, the Predictor and its HTTP front-end."""
from .auc import StreamingPredictions, roc_auc, roc_curve
from .evaluate import evaluate, evaluate_from_config, recalibrate_bn
from .predict import Predictor

__all__ = ["StreamingPredictions", "roc_auc", "roc_curve", "evaluate",
           "evaluate_from_config", "recalibrate_bn", "Predictor"]
