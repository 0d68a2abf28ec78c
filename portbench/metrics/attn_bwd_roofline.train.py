"""The text encoders' attention backward against its roofline: the least
time its calls in the traced window could take (work.bwd_work: bytes at
3.35 TB/s, products at 989 TFLOP/s, over the keys the pad masks leave),
summed per call, over the device time of the kernels that compute it.

The calls: every text layer of both encoders, once a micro-batch, over
that micro-batch's chunk rows.  The kernels: the split attention
backward's (csrc/flash_attention_bwd.cu: the dq kernel and the dk/dv one),
told from the packed instantiation by its template flag."""
import re

from portbench.work import in_path_bounds

KERNELS = r"attention_bwd"
PACKED = re.compile(r"_bf16<\d+, true>")


def read(run):
    if run.trace is None or not run.traced or run.cell.mix["driver"] != "train":
        return None
    seconds = sum(v for k, v in run.trace.op_s.items()
                  if re.search(KERNELS, k) and not PACKED.search(k))
    if seconds <= 0:
        return None
    p = run.port
    heads = int(p["model.text.num_heads"])
    dh = int(p["model.text.hidden_size"]) // heads
    layers = int(p["model.text.num_layers"])
    calls = []
    for b in run.traced:
        for side in ("user", "item"):
            tok = b[f"{side}_tokens"]
            pad = tok == int(p["model.text.pad_token_id"])
            calls += [(tok.shape[0], tok.shape[1], heads, dh, pad, True, 2)] * layers
    ms, _ = in_path_bounds(calls, backward=True)
    return 100.0 * ms / 1e3 / seconds
