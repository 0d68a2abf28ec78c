"""BENCHMARK.json against the contract's shape, and every name it holds
resolved to its files."""
import json
import os
import re

import pytest

from portbench.bench import HERE, ROOT, metrics_of
from tinycells import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert m["command"] == ["python3", "portbench/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    m = manifest()
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[kind]
    names = [e["name"] for e in m[kind]]
    assert len(names) == len(set(names))
    for e in m[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"])
        for text in ("why", "layer", "source"):
            if text in e and kind in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_every_cell_resolves_to_its_files():
    m = manifest()
    configs = {c["name"]: c for c in m["configs"]}
    for c in m["configs"]:
        assert c["file"].startswith("portbench/configs/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not re.search(r"(hidden|intermediate|_dim|_rank|head|size)", k)
    used = set()
    pairs = set()
    for w in m["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        mix = json.load(open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")))
        assert os.path.exists(os.path.join(HERE, "drivers", f"{mix['driver']}.py"))
        assert os.path.exists(os.path.join(HERE, "limits", f"{w['name']}.json"))
        mine = metrics_of(m, w["name"])
        assert "setup_s" in [e["name"] for e in mine["end_to_end"]]
        assert len(mine["end_to_end"]) >= 2 and mine["per_layer"]
    assert used == set(configs)
    for e in m["end_to_end"] + m["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", f"{e['name']}.py"))
    e2e = {e["name"] for e in m["end_to_end"]}
    for e in m["per_layer"]:
        assert e["moves"] in e2e
        for w in e.get("workloads", []):
            assert e["moves"] in [x["name"] for x in metrics_of(m, w)["end_to_end"]]


def test_port_tables_name_real_fields():
    from mmoe_multimodal_rec_tpu_torch.config import Config
    m = manifest()
    for c in m["configs"]:
        port = json.load(open(os.path.join(ROOT, c["file"])))["port"]
        Config().override(**port)
    for w in m["workloads"]:
        mix = json.load(open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")))
        Config().override(**mix.get("port", {}))
