"""The ranking forward's self-attention (every text layer of both encoders
over the batch's chunk rows, with its pad mask; every ViT layer over the
bucket's samples, unmasked) against its roofline: the least time of its
calls in the traced window (work.fwd_work: bytes at 3.35 TB/s, products
at 989 TFLOP/s, over the keys the masks leave), summed per call, over the
device time of the packed attention forward kernel
(csrc/flash_attention_fwd.cu, told from the split one by its template
flag)."""
import re

from portbench.work import in_path_bounds

SPLIT = re.compile(r"_bf16<\d+, true")


def read(run):
    if run.trace is None or not run.traced or run.cell.mix["driver"] != "rank":
        return None
    seconds = sum(v for k, v in run.trace.op_s.items()
                  if "attention_fwd" in k and not SPLIT.search(k))
    if seconds <= 0:
        return None
    p = run.port
    heads = int(p["model.text.num_heads"])
    dh = int(p["model.text.hidden_size"]) // heads
    hi = int(p["model.image.num_heads"])
    dhi = int(p["model.image.hidden_size"]) // hi
    li = int(p["model.image.num_patches"]) + 1
    calls = []
    for b in run.traced:
        bucket = b["user_sent_chunk"].shape[0]
        for side in ("user", "item"):
            tok = b[f"{side}_tokens"]
            pad = tok == int(p["model.text.pad_token_id"])
            calls += [(tok.shape[0], tok.shape[1], heads, dh, pad, False, 2)] \
                * int(p["model.text.num_layers"])
        calls += [(bucket, li, hi, dhi, None, False, 2)] \
            * int(p["model.image.num_layers"])
    ms, _ = in_path_bounds(calls)
    return 100.0 * ms / 1e3 / seconds
