"""Hand-written Hopper kernels (csrc/), their wrappers and plain PyTorch
versions.  Importing builds nothing: each kernel is built by nvcc at its
first launch on a CUDA tensor.  The split-attention wrapper stays at
`ops.flash_attention.flash_attention`: re-exported here, it would hide the
module of the same name."""
from .flash_attention import flash_attention_packed, pack_qkv_weights
from .lora_dropout import lora_dropout_matmul

__all__ = ["flash_attention_packed", "pack_qkv_weights",
           "lora_dropout_matmul"]
