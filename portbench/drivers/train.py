"""Training traffic: optimizer steps of `Trainer.run_step` over a pool of
host batches, cycled, so every step copies its batch to the device as a
loader's would.

Set-up builds the Trainer, hands it the seeded weights, and drives it
through the mix's `check_steps` first steps on distinct batches; those
steps also warm up every shape.  The first gradient (as AdamW got it:
its first moment after one step over 1 - beta1) and the trainable state
after the last check step are kept on the host.  The window then runs
whole steps on the same Trainer until `seconds` have passed; the rate is
every example of every step over the window's length.  Once the window has
closed and the program's state is freed, the plain reference follows the
same first steps from the same weights, batches and dropout seeds, and
the three numbers below are compared:
- loss_gap: the largest relative gap of a step's loss;
- grad_gap, change_gap: over the leaves whose reference gradient is at
  least a thousandth of the median leaf's, the largest gap between the
  program's and the reference's norm of a leaf's first gradient (of its
  change over the check steps), over the larger of the reference leaf's
  norm and the median leaf's.  HoME's BatchNorm statistics count as leaves
  of the change.
A number missing from the cell's limits file is printed and not compared.
"""
from __future__ import annotations

import statistics
from typing import Dict

from ..batches import train_pool
from ..bench import Run, free_device, now
from ..reference.model import is_buffer
from ..reference.train import train_steps, trainable_names
from ..spans import Spans
from ..trace import Trace
from ..weights import load_into, make_weights


def _norms(d: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    """A leaf the program has no reading of (no optimizer state) reads 0."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def compare(run: Run, losses, g1, th0, th3, ref) -> None:
    """Sets run.checks and run.correct from the program's readings and the
    reference's."""
    lim = run.cell.limits
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    rg = _norms(ref["first_grads"])
    med = statistics.median(rg.values())
    leaves = [k for k in rg if rg[k] >= 1e-3 * med]
    run.notes.append(f"leaves compared {len(leaves)} of {len(rg)}; "
                     f"left out (gradient under 1e-3 of the median): "
                     f"{sorted(set(rg) - set(leaves))[:8]}")
    grad_gap = gaps(_norms(g1), rg, leaves)
    d_prog = {k: th3[k] - th0[k].cpu() for k in th3}
    d_ref = {k: ref["params"][k].cpu() - th0[k].cpu() for k in ref["params"]}
    d_ref.update({k: ref["stats"][k].cpu() - th0[k].cpu() for k in ref["stats"]})
    moved = leaves + [k for k in ref["stats"]]
    change_gap = gaps(_norms(d_prog), _norms(d_ref), moved)
    ok = []
    for name, value in (("loss_gap", loss_gap), ("grad_gap", grad_gap),
                        ("change_gap", change_gap)):
        if name in lim:
            ok.append(run.judge(name, value, lim[name]))
        else:   # a number the cell's limits leave out (PERF.md says why)
            run.notes.append(f"{name} read {value!r}, not compared")
    run.correct = bool(ok) and all(ok)


def setup_note(spans) -> str:
    return "set-up spans (s): " + ", ".join(
        f"{k} {sum(b - a for a, b in v):.2f}" for k, v in spans.times.items()
        if k != "pb.step") + ", first steps " + " ".join(
        f"{b - a:.2f}" for a, b in spans.times.get("pb.step", [])[:4])


def run(cell) -> Run:
    import torch
    from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
    r = Run(cell)
    spans = r.spans = Spans()
    mix, port = cell.mix, cell.port
    lengths = cell.traffic(mix["lengths_from"])
    with spans.span("pb.traffic"):
        pool = train_pool(cell.seed, mix, lengths, port)
    cfg = cell.program_config()
    with spans.span("pb.init"):
        trainer = Trainer(cfg, device=cell.device)
        weights = make_weights(port, cell.seed, cell.device)
        load_into(trainer.model, weights)
        th0 = {k: v.detach().cpu() for k, v in weights.items()}
        del weights
    names = trainable_names(port, list(th0))
    if sorted(names) != sorted(trainer.trainable):
        raise RuntimeError("the program trains other parameters than the "
                           "recipe: " + str(sorted(set(names) ^
                                                   set(trainer.trainable))[:6]))
    if cell.fault is not None:
        cell.fault(trainer)
    b1 = float(port["train.optim.b1"])
    checks = int(mix["check_steps"])
    losses = []
    for t in range(checks):
        with spans.span("pb.step"):
            out = trainer.run_step(pool[t])
        losses.append(out["loss"])
        if t == 0:
            g1 = {n: (trainer.optimizer.state[p]["exp_avg"] / (1.0 - b1)).cpu()
                  for n, p in trainer.trainable.items()
                  if p in trainer.optimizer.state}
    state = dict(trainer.model.named_buffers())
    th3 = {n: p.detach().cpu().clone() for n, p in trainer.trainable.items()}
    th3.update({k: v.detach().cpu().clone() for k, v in state.items()
                if is_buffer(k)})
    if cell.trace:
        Trace.warm()
    cell.sync()
    r.setup_s = now() - cell.t_start
    if cell.trace:
        r.trace = Trace()
        r.trace.start()
    t0 = now()
    k = checks
    traced = int(mix["trace_steps"]) if cell.trace else 0
    while True:
        with spans.span("pb.step"):
            trainer.run_step(pool[k % len(pool)])
        k += 1
        if k - checks == traced:
            r.trace.stop(r.spans)
            r.notes.append(f"{traced} steps traced, read in "
                           f"{r.trace.read_s:.1f} s")
        if now() - t0 >= cell.seconds and k - checks >= traced:
            break
    r.window_s = now() - t0
    steps = k - checks
    ends = [b - t0 for a, b in spans.times["pb.step"][checks:]]
    r.notes.append("window step ends (s): " + " ".join(f"{x:.3f}" for x in ends))
    accum = int(mix["grad_accum"])
    r.work = steps * accum * int(mix["batch_size"])
    r.attempted = steps
    r.traced = [{key: v[i] for key, v in pool[j % len(pool)].items()}
                for j in range(checks, checks + traced) for i in range(accum)]
    if cell.device != "cpu":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del trainer, state
    free_device()
    weights = make_weights(port, cell.seed, cell.device)
    t1 = now()
    ref = train_steps(port, weights, pool[:checks], int(port["train.seed"]),
                      cell.precision)
    r.notes.append(f"reference: {now() - t1:.1f} s for {checks} steps")
    r.notes.append(setup_note(spans))
    compare(r, losses, g1, th0, th3, ref)
    r.notes.append("losses program " + " ".join(f"{x:.6f}" for x in losses)
                   + " reference " + " ".join(f"{x:.6f}" for x in ref["losses"]))
    del weights, ref
    free_device()
    return r
