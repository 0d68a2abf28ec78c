"""Every (user, item) pair returned in the window over the window's length;
the window opens at a device batch's completion and closes at the first
completion `seconds` later, so it holds whole batches only."""


def read(run):
    if run.cell.mix["driver"] != "rank":
        return None
    return run.work / run.window_s if run.window_s > 0 else None
