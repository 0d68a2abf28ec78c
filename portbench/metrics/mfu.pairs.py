"""The whole ranking forward's share of the card's bf16 peak: the useful
products (work.model_flops) of the real pairs of the device batches that
completed in the traced window, over the window's length and 989
TFLOP/s."""
from portbench.work import BF16_FLOPS_PER_S, model_flops


def read(run):
    if run.trace is None or not run.traced or run.cell.mix["driver"] != "rank":
        return None
    flops = sum(model_flops(run.port, b, train=False, n_real=n)
                for b, n in zip(run.traced, run.traced_real))
    return 100.0 * flops / run.traced_s / BF16_FLOPS_PER_S
