"""mmoe_multimodal_rec_tpu_torch — the PyTorch + CUDA port of
mmoe_multimodal_rec_tpu for NVIDIA Hopper (H100).

Module paths and class names mirror the JAX package, so each module's
counterpart is easy to find; nothing here imports jax or the JAX package.
Ported so far, the LoRA-merged serving path and the baseline training
step:

- config, host text packing and the shard data path (copies of the JAX
  package's jax-free modules)                           -> `config.py`, `data/`
- the self-attention kernels, hand-written CUDA for sm_90a, with their
  plain PyTorch versions: packed-qkv forward, split-q/k/v forward and
  backward with in-kernel dropout                       -> `ops/`, `csrc/`
- the baseline MMoE model with its dropout sites        -> `models/`
- losses, optimizer groups, the accumulated step, the
  Trainer, checkpoints, preemption                      -> `train/`
- LoRA merge, JAX param conversion, metrics logging     -> `utils/`
- Predictor + HTTP server                               -> `eval/`
- CLI `synth`, `train`, `serve`                         -> `cli.py`
"""

__version__ = "0.1.0"
