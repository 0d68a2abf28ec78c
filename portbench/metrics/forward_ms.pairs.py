"""Host milliseconds of the predictor's forward a device batch (its inputs
to the device, the model, the sigmoid, the scores back to the host),
averaged over the batches that completed in the window.  Nothing to read
where the predictor has no `_forward` to time."""


def read(run):
    batches = getattr(run, "batches", None)
    if run.cell.mix["driver"] != "rank" or not batches:
        return None
    total = sum(b["forward_s"] for b in batches)
    return 1e3 * total / len(batches) if total > 0 else None
