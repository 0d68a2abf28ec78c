"""mmoe_multimodal_rec_tpu_torch — the PyTorch + CUDA port of
mmoe_multimodal_rec_tpu for NVIDIA Hopper (H100).

Module paths and class names mirror the JAX package, so each module's
counterpart is easy to find; nothing here imports jax or the JAX package.
This slice ports the LoRA-merged serving path:

- config + host text packing (copies of the JAX package's jax-free modules)
                                                        -> `config.py`, `data/`
- the packed-qkv self-attention kernel, hand-written CUDA for sm_90a,
  with its plain PyTorch version                        -> `ops/`, `csrc/`
- the baseline MMoE model, inference only               -> `models/`
- LoRA merge + JAX param conversion                     -> `utils/`
- Predictor + HTTP server, CLI `serve`                  -> `eval/`, `cli.py`
"""

__version__ = "0.1.0"
