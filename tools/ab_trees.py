#!/usr/bin/env python3
"""The benchmark on two trees, a parent and a change, as a comparison of
two trees runs them: one process a cell, the trees in turns on one
machine.

    python3 tools/ab_trees.py PARENT CHANGE --out FILE [--cells A,B]
                              [--pairs N] [--timeout S]

from the repository root, on the card.  PARENT and CHANGE hold the two
trees (`git archive <commit> | tar -x -C DIR`, once for each).  Both
BENCHMARK.json files must give the same `command`.  In each of N rounds
(default 3) it runs, for each cell (default: every cell the cards
present hold), that command with `--out` from PARENT then CHANGE on even
rounds and the other way round on odd ones (P C C P ...), through
tools/aa_spread.py's process runner: each round of a cell is one pair.

FILE is one JSON file for the call, rewritten after every process, in
aa_spread.py's layout: the card and power limit, the command, the digest
of each file the runner runs for each tree (`files`: {"P": ..., "C":
...}), and for each cell its processes in run order (side "P" or "C",
round, exit code, wall seconds and the runner's records of the cell).
At the end it prints, for each metric of each cell, the median over the
rounds of the pair's ratio (change over parent), each tree's values, and
the widest gap between two processes of one tree (|a - b| over their
mean): a ratio's shortfall from 1 reads as a fall only beyond it.
Exits 1 if a process failed.
"""
import argparse
import json
import shlex
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import aa_spread  # noqa: E402
from bench_torch import bounds  # noqa: E402

SIDES = ("P", "C")


def order(rounds):
    """The trees of each round: P C on even rounds, C P on odd ones."""
    return [SIDES if r % 2 == 0 else SIDES[::-1] for r in range(rounds)]


def summary(call):
    """{cell: {metric: {"ratio": median pair ratio C / P, "P": [...],
    "C": [...], "one_tree_gap": widest gap within one tree}}} of a call's
    processes that succeeded."""
    out = {}
    for name, procs in call["cells"].items():
        rounds = {}
        for p in procs:
            if p.get("ok") and p.get("rc") == 0:
                rounds.setdefault(p["round"], {})[p["side"]] = p
        metrics = sorted({m for r in rounds.values() for p in r.values()
                          for m in p.get("metrics", {})})
        cell = out[name] = {}
        for m in metrics:
            vals = {s: [r[s]["metrics"][m]["value"] for _, r in
                        sorted(rounds.items()) if s in r
                        and m in r[s].get("metrics", {})] for s in SIDES}
            ratios = [r["C"]["metrics"][m]["value"]
                      / r["P"]["metrics"][m]["value"]
                      for r in rounds.values() if set(SIDES) <= set(r)
                      and all(m in r[s]["metrics"] for s in SIDES)]
            cell[m] = {
                "ratio": statistics.median(ratios) if ratios else None,
                **vals,
                "one_tree_gap": max((bounds.spread(v) for v in vals.values()
                                     if len(v) > 1), default=None)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--cells", help="comma-separated cell names (default: "
                    "every cell the cards present hold)")
    ap.add_argument("--pairs", type=int, default=3, help="rounds a cell")
    ap.add_argument("--out", required=True, help="the call's JSON file")
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds a process may take")
    args = ap.parse_args(argv)
    sides = {"P": Path(args.parent).resolve(),
             "C": Path(args.change).resolve()}
    benches = {s: json.loads((d / "BENCHMARK.json").read_text())
               for s, d in sides.items()}
    command = benches["P"]["command"]
    if benches["C"]["command"] != command:
        raise SystemExit("the trees' BENCHMARK.json commands differ")
    cards = aa_spread.card_lines()
    if not cards:
        print("ab_trees: no card", file=sys.stderr)
        return 1
    chips = {w["name"]: w["chips"] for w in benches["P"]["workloads"]}
    names = args.cells.split(",") if args.cells else \
        [n for n, c in chips.items() if c <= len(cards)]
    unknown = [n for n in names if n not in chips]
    if unknown:
        ap.error(f"unknown cells {unknown}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    logs = out.parent / f"{out.stem}_logs"
    logs.mkdir(exist_ok=True)
    call = {"trees": {s: str(d) for s, d in sides.items()},
            "card": cards[0], "cards": len(cards), "command": command,
            "files": {s: aa_spread.file_digests(d, command)
                      for s, d in sides.items()},
            "pairs": args.pairs, "cells": {n: [] for n in names}}
    print(f"ab_trees {cards[0]} x{len(cards)} | {args.pairs} rounds of "
          f"{names} | {command}", flush=True)
    failed = 0
    with tempfile.TemporaryDirectory(prefix="ab_trees_") as tmp:
        for rnd, pair in enumerate(order(args.pairs)):
            for name in names:
                for side in pair:
                    res = Path(tmp) / f"{name}_{rnd}_{side}.json"
                    cmd = shlex.split(command.format(name=name)) \
                        + ["--out", str(res)]
                    rc, wall = aa_spread.run_process(
                        cmd, sides[side], logs / f"{name}_{rnd}_{side}.log",
                        args.timeout)
                    proc = {"side": side, "round": rnd, "rc": rc,
                            "wall_s": wall, **aa_spread.kept(res, name)}
                    failed += rc != 0 or not proc["ok"]
                    call["cells"][name].append(proc)
                    out.write_text(json.dumps(call) + "\n")
                    values = " ".join(
                        f"{m}={x['value']:.2f}"
                        for m, x in proc.get("metrics", {}).items())
                    print(f"  {name} round {rnd} {side} rc={rc} "
                          f"wall={wall:.1f}s {values}", flush=True)
    for name, metrics in summary(call).items():
        for m, s in metrics.items():
            fmt = (lambda x: "-" if x is None else f"{x:.4f}")
            print(f"ab {name} {m} ratio={fmt(s['ratio'])} one_tree_gap="
                  f"{fmt(s['one_tree_gap'])} P={[round(v, 2) for v in s['P']]}"
                  f" C={[round(v, 2) for v in s['C']]}")
    print(json.dumps({"ok": not failed, "out": str(out),
                      "processes": sum(map(len, call["cells"].values()))}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
