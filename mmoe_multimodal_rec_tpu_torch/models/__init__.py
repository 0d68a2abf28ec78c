"""The baseline MMoE model in PyTorch (inference only)."""
