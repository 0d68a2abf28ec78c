"""Share of the traced window of the saturated ranking cell in which no
operation ran on the device (1 - busy / window)."""


def read(run):
    if run.trace is None or run.cell.mix["driver"] != "rank":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
