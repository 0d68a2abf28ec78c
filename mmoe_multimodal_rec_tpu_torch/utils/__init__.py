"""LoRA merge, weight and layout conversion from the JAX package's param
trees (shared-base and scan-layers included), reference checkpoints, and
metrics logging.  (The JAX package's plotting helpers are not ported
yet.)"""
from .metrics import MetricsLogger, Throughput

__all__ = ["MetricsLogger", "Throughput"]
