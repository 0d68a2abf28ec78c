"""LoRA merge and weight conversion from the JAX package's param tree."""
