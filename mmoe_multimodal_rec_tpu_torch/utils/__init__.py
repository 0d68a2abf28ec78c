"""LoRA merge, weight and layout conversion from the JAX package's param
trees (shared-base and scan-layers included), reference checkpoints,
metrics logging, and the loss-curve and ROC PNGs (matplotlib imported
when a plot is drawn)."""
from .metrics import MetricsLogger, Throughput
from .plotting import plot_epoch_losses, plot_loss_curves, plot_roc

__all__ = ["MetricsLogger", "Throughput", "plot_epoch_losses",
           "plot_loss_curves", "plot_roc"]
