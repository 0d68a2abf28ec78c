"""Every cell driven end to end on the CPU at a tiny size: the program on
its plain fp32 path against the plain reference, which must agree to
rounding (far inside the cells' limits)."""
import pytest

from tinycells import manifest, run

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name):
    r = run(name)
    assert r.correct, r.checks
    assert r.failed == 0 and r.attempted > 0
    for check, value, limit in r.checks:
        assert value <= (0 if check == "pack_mismatch" else 1e-4), (check, value)
    assert set(r.metrics) == {m["name"] for m in r.cell.metrics["end_to_end"]}
    assert all(v["value"] > 0 for v in r.metrics.values())
