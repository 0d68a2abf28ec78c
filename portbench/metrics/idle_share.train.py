"""Share of the traced training window in which no operation ran on the
device (torch.profiler's timeline: 1 - busy / window)."""


def read(run):
    if run.trace is None or run.cell.mix["driver"] != "train":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
