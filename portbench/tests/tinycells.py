"""Cells of the benchmark at a size the CPU runs in seconds: the
configurations' widths cut to 32, two text layers, short chunks; the
program on its plain path, in fp32."""
import os
import time

from portbench.bench import ROOT, Cell, load_json, run_cell

TINY = {
    "model.text.hidden_size": 32, "model.text.num_layers": 2,
    "model.text.num_heads": 4, "model.text.intermediate_size": 64,
    "model.text.max_position_embeddings": 48, "model.text.lora_rank": 2,
    "model.image.hidden_size": 32, "model.image.num_layers": 12,
    "model.image.num_heads": 4, "model.image.intermediate_size": 64,
    "model.packer.max_tok": 24, "model.packer.fixed_sent_count": 6,
    "model.d": 32, "model.cross_heads": 4, "model.fuse_heads": 4,
    "model.tower_hidden": 16, "model.home_tower_hidden": 16,
    "model.home_expert_hidden": 24, "model.compute_dtype": "float32",
    "model.use_flash_attention": False,
}
TRAIN = dict(TINY, **{"train.batch_size": 4,
                      "model.packer.chunk_budget": 8})
RANK = dict(TINY, **{"train.batch_size": 8, "model.packer.chunk_budget": 16})
MIX = {"train": {"batch_size": 4, "pool_steps": 3},
       "rank": {"bucket": 8, "pairs_per_request": 4, "clients": 4,
                "requests": 120, "lead_in_s": 0.3,
                "check_batches": 16}}


def manifest():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


# The cells' limits are set at their own size on the card (PERF.md); at this
# size the program agrees with the reference to 1e-4 (test_portbench_reference)
# and an fp8 product is off by far less than at full width, so each number the
# cell compares is held to a limit of this size's own.
TINY_LIMIT = 1e-3


def cell(name, seed=20240611, seconds=1.0, precision="fp32", fault=None):
    m = manifest()
    entry = {w["name"]: w for w in m["workloads"]}[name]
    driver = Cell.traffic(entry["traffic"])["driver"]
    c = Cell(m, name, seed, seconds, False, time.perf_counter(),
             device="cpu", port_overrides=TRAIN if driver == "train" else RANK,
             mix_overrides=MIX[driver], precision=precision, fault=fault)
    c.limits = {k: 0 if k == "pack_mismatch" else TINY_LIMIT for k in c.limits}
    return c


def run(name, **kw):
    return run_cell(cell(name, **kw))
