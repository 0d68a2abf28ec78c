"""The harness: finds a cell by name in BENCHMARK.json, runs its traffic's
driver, reads its metrics and prints the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name:
  portbench/configs/<config>.json    the configuration (file named in the
                                     manifest), its "port" table of sizes
  portbench/traffic/<traffic>.json   the mix; its "driver" names
                                     portbench/drivers/<driver>.py
  portbench/limits/<workload>.json   the limits of the cell's comparison
  portbench/metrics/<metric>.py      a reader: read(run) -> number or None
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mmoe_multimodal_rec_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest, resolved to its files."""

    def __init__(self, manifest: dict, name: str, seed: int, seconds: float,
                 trace: bool, t_start: float, device: str = "cuda",
                 port_overrides: Optional[dict] = None,
                 mix_overrides: Optional[dict] = None,
                 precision: str = "fp32", fault=None):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(ROOT, self.config_entry["file"]))
        self.mix = self.traffic(self.entry["traffic"])
        self.mix.update(mix_overrides or {})
        self.port = dict(self.config["port"])
        self.port.update(self.mix.get("port", {}))
        self.port.update(port_overrides or {})
        self.port["train.seed"] = seed % (1 << 31)
        self.limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.t_start = t_start
        self.device = device
        self.precision = precision
        self.fault = fault
        self.chips = int(self.entry["chips"])
        self.metrics = metrics_of(manifest, name)

    @staticmethod
    def traffic(name: str) -> dict:
        return load_json(os.path.join(HERE, "traffic", f"{name}.json"))

    def program_config(self):
        from mmoe_multimodal_rec_tpu_torch.config import Config
        return Config().override(**self.port)

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()


def metrics_of(manifest: dict, cell: str) -> Dict[str, List[dict]]:
    """The cell's end-to-end metrics and, for a traced run, its per-layer
    ones: a metric with a `workloads` list belongs to those cells; one
    without, to every cell (per-layer: every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_record(run, chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}


def run_cell(cell: Cell):
    """Runs the cell's driver; returns its Run record (metrics read)."""
    driver = importlib.import_module(f"portbench.drivers.{cell.mix['driver']}")
    run = driver.run(cell)
    group = "per_layer" if cell.trace else "end_to_end"
    run.metrics = {}
    for m in cell.metrics[group]:
        value = reader(m["name"])(run)
        if value is None:
            if group == "end_to_end":
                raise RuntimeError(f"{m['name']}: nothing to read")
            continue
        run.metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return run


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(manifest, args.workload, args.seed, args.seconds,
                bool(args.trace), t_start)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(int(cell.mix.get("threads", 4)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = run_cell(cell)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}, which the port must not", file=sys.stderr)
        return 3
    result = {"correct": bool(run.correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": run.metrics,
              "device": device_record(run, cell.chips)}
    if cell.trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    print(f"peak device memory: {run.memory_peak_bytes} bytes",
          file=sys.stderr)
    for line in run.notes:
        print(line, file=sys.stderr)
    checks = {}
    for name, value, limit in run.checks:
        checks[name] = {"value": value, "limit": limit}
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


class Run:
    """What a driver hands the metric readers."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.port = cell.port
        self.window_s = 0.0
        self.work = 0.0           # examples or pairs completed in the window
        self.attempted = 0
        self.failed = 0
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.trace = None
        self.traced: List[dict] = []      # inputs run in the traced window
        self.traced_real: List[int] = []  # real samples of each
        self.spans = None
        self.checks: List[tuple] = []
        self.notes: List[str] = []
        self.correct = False
        self.metrics: Dict[str, dict] = {}

    def judge(self, name: str, value: float, limit: float) -> bool:
        self.checks.append((name, value, limit))
        return value <= limit


def free_device() -> None:
    gc.collect()
    try:
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    except ImportError:
        pass


def now() -> float:
    return time.perf_counter()
