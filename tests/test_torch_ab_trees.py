"""tools/ab_trees.py: the benchmark's command on a parent and a change,
one process a cell, the trees in turns (P C C P ...), and the median pair
ratio beside the widest gap within one tree.  A fake runner stands in for
bench_torch/run.py: its MiB/s come from the tree it runs in."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

FAKE_RUNNER = """
import argparse, json, os, sys
ap = argparse.ArgumentParser()
ap.add_argument("--cells")
ap.add_argument("--out")
a = ap.parse_args()
side = os.path.basename(os.getcwd())
with open(os.environ["AB_ORDER"], "a") as f:
    f.write(f"{side} {a.cells}\\n")
with open(os.environ["AB_ORDER"]) as f:
    n = sum(1 for line in f if line.startswith(side))
value = {"P": 100.0, "C": 110.0}[side] + n
rec = {"value": value, "median": value, "calls": [value]}
res = {"metrics": {"decode_mibs": rec}, "reference": {}, "errors": [],
       "operations": {"attempted": 1, "failed": 0, "reference_failed": 0},
       "setup": {}, "layers": {}}
json.dump({"card": "FAKE, 700.00 W", "ok": a.cells != "bad",
           "setup": {}, "cells": {a.cells: res}}, open(a.out, "w"))
"""


def fake_tree(path, command):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["command"] = command
    bench["workloads"].append({"name": "bad", "chips": 1, "metrics": {}})
    for d in ("bench_torch", "libaec_tpu_torch"):
        (path / d).mkdir(parents=True)
    (path / "chip_smoke.py").write_text("")
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    (path / "bench_torch" / "run.py").write_text(FAKE_RUNNER)
    return path


@pytest.fixture
def ab(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import ab_trees
    monkeypatch.setattr(ab_trees.aa_spread, "card_lines",
                        lambda: ["FAKE, 700.00 W"])
    return ab_trees


def test_the_trees_run_in_turns_and_pairs_give_the_ratio(tmp_path, ab,
                                                        monkeypatch):
    cmd = f"{sys.executable} bench_torch/run.py --cells {{name}}"
    p, c = (fake_tree(tmp_path / s, cmd) for s in ("P", "C"))
    (c / "libaec_tpu_torch" / "decode.py").write_text("# the change\n")
    monkeypatch.setenv("AB_ORDER", str(tmp_path / "order"))
    out = tmp_path / "tried" / "ab.json"
    names = ["bench16-field-256MiB", "bench16-many-256x1MiB"]
    assert ab.main([str(p), str(c), "--cells", ",".join(names),
                    "--pairs", "3", "--out", str(out)]) == 0
    ran = (tmp_path / "order").read_text().split("\n")[:-1]
    assert ran == [f"{side} {n}" for pair in ("PC", "CP", "PC")
                   for n in names for side in pair]
    call = json.loads(out.read_text())
    assert call["card"] == "FAKE, 700.00 W" and call["command"] == cmd
    assert "libaec_tpu_torch/decode.py" in call["files"]["C"]
    assert "libaec_tpu_torch/decode.py" not in call["files"]["P"]
    procs = call["cells"][names[0]]
    assert [p["side"] for p in procs] == list("PCCPPC")
    assert [p["round"] for p in procs] == [0, 0, 1, 1, 2, 2]
    s = ab.summary(call)[names[0]]["decode_mibs"]
    # P's processes read 101, 103, 105 and C's 111, 113, 115 (each
    # tree's n-th process adds n): pairs 111/101, 113/103, 115/105
    assert s["P"] == [101.0, 103.0, 105.0]
    assert s["C"] == [111.0, 113.0, 115.0]
    assert s["ratio"] == pytest.approx(113 / 103)
    assert s["one_tree_gap"] == pytest.approx(4 / 103)


def test_a_failed_process_fails_the_call(tmp_path, ab, monkeypatch):
    cmd = f"{sys.executable} bench_torch/run.py --cells {{name}}"
    p, c = (fake_tree(tmp_path / s, cmd) for s in ("P", "C"))
    monkeypatch.setenv("AB_ORDER", str(tmp_path / "order"))
    out = tmp_path / "ab.json"
    assert ab.main([str(p), str(c), "--cells", "bad", "--pairs", "1",
                    "--out", str(out)]) == 1
    assert ab.summary(json.loads(out.read_text())) == {"bad": {}}


def test_two_commands_are_refused(tmp_path, ab):
    p = fake_tree(tmp_path / "P", "python3 bench_torch/run.py --cells {name}")
    c = fake_tree(tmp_path / "C", "python3 other.py --cells {name}")
    with pytest.raises(SystemExit):
        ab.main([str(p), str(c), "--out", str(tmp_path / "ab.json")])
