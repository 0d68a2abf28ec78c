"""Host milliseconds a device batch spends inside the predictor's packer
calls (sentence split, WordPiece, chunk packing; user and item sides
together), averaged over the batches that completed in the window.
Nothing to read where a batch made no packer call: its packing then ran
where this reader does not see it."""


def read(run):
    batches = getattr(run, "batches", None)
    if run.cell.mix["driver"] != "rank" or not batches:
        return None
    if any(not b["packs"] for b in batches):
        return None
    return 1e3 * sum(b["pack_s"] for b in batches) / len(batches)
