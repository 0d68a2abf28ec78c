"""The whole training step's share of the card's bf16 peak: the useful
products of the micro-batches run in the traced window (work.model_flops,
forward and backward) over the window's length and 989 TFLOP/s."""
from portbench.work import BF16_FLOPS_PER_S, model_flops


def read(run):
    if run.trace is None or not run.traced or run.cell.mix["driver"] != "train":
        return None
    flops = sum(model_flops(run.port, b, train=True) for b in run.traced)
    return 100.0 * flops / run.trace.window_s / BF16_FLOPS_PER_S
