"""The benchmark is driven by data: every cell, configuration and
per-layer metric of BENCHMARK.json is a file of its own, found by name."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark.check import NUMBERS
from benchmark.layout import Layout

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_a_new_cell_is_a_new_file(tmp_path):
    d = tmp_path / "benchmark"
    (d / "workloads").mkdir(parents=True)
    (d / "workloads" / "x.n8-p2.merged-lf4.json").write_text(json.dumps(
        {"config": "c", "traffic": "merged-lf4", "chips": 1, "why": "w",
         "limits": {}}))
    cell = Layout(d).cell("x.n8-p2.merged-lf4")
    assert cell["traffic"] == "merged-lf4"
    with pytest.raises(FileNotFoundError):
        Layout(d).cell("absent")


def test_every_entry_has_its_file():
    lay = Layout()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = lay.cell(w["name"])
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert set(cell["limits"]) == set(NUMBERS)
        assert w["chips"] == 1  # the harness runs one-chip cells
        assert lay.traffic(w["traffic"])["rate_metric"] in {
            e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert callable(lay.reader(m["name"]))


def test_per_layer_lists_follow_benchmark_json():
    lay = Layout()
    for w in BENCH["workloads"]:
        names = {m["name"] for m in lay.per_layer(w["name"], set())}
        assert names == {m["name"] for m in BENCH["per_layer"]
                         if w["name"] in m.get("workloads", [])}


def test_readers_find_nothing_off_their_layer():
    lay = Layout()
    ctx = SimpleNamespace(spans={}, shape=dict(dim=3, E=1, n_p=20,
                                                        nf=4, n_fp=10),
                          scheme="lf4", family="merged", group_ms={},
                          busy_s=0.0, window_s=0.0, enqueue_ms=None,
                          ms_per_step=None, on_card=True)
    for m in BENCH["per_layer"]:
        assert lay.reader(m["name"])(ctx) is None, m["name"]
