"""Every example of every optimizer step completed in the window, over the
window's length (host clock, the window ending with its last step)."""


def read(run):
    if run.cell.mix["driver"] != "train" or run.window_s <= 0:
        return None
    return run.work / run.window_s
