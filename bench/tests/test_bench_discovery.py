"""The harness finds a cell, a traffic mix and a metric that were added
as files alone, with entries in BENCHMARK.json and no code edited."""
import json
import shutil

import tinycell
from harness import cell as C
from harness.driver import Log


def test_a_cell_a_mix_and_a_metric_added_as_files(tmp_path):
    root = tmp_path
    shutil.copytree(tinycell.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((tinycell.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "yi6b.burst", "config": "yi-6b", "traffic": "burst",
        "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "late_s", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "engine scheduler, host",
        "moves": "ttft_p95_ms", "workloads": ["yi6b.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((tinycell.BENCH / "traffic" / "rag.json").read_text())
    mix["block"] = 16
    (root / "bench" / "traffic" / "burst.json").write_text(json.dumps(mix))
    spec = json.loads((tinycell.BENCH / "workloads" / "yi6b.rag.json")
                      .read_text())
    (root / "bench" / "workloads" / "yi6b.burst.json").write_text(
        json.dumps(spec))
    (root / "bench" / "metrics" / "late_s.py").write_text(
        "def read(run):\n    return run.log.late\n")

    cell = C.Cell.find("yi6b.burst", root)
    assert cell.mix["block"] == 16
    assert cell.conf["name"] == "yi-6b"
    assert [m["name"] for m in cell.metrics["per_layer"]][-1] == "late_s"
    assert "late_s" not in [m["name"] for m in
                            C.Cell.find("yi6b.rag", root).metrics["per_layer"]]

    class Run:
        log = Log(seconds=1.0, records={}, iterations=[], late=0.25)
    assert C.read_metric("late_s", Run(), root) == 0.25


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((tinycell.ROOT / "BENCHMARK.json").read_text())
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert (tinycell.BENCH / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        cell = C.Cell.find(w["name"], tinycell.ROOT)
        assert cell.spec["engine"]["max_lanes"] == 64
        assert cell.spec["engine"]["chunk"] == 128
        assert cell.spec["engine"]["page_size"] == 16
        assert cell.entry["chips"] == 1
