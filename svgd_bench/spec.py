"""What a run is told: BENCHMARK.json's entry for the cell, its
configuration, traffic mix and limits, each found by its name.

    configs/<config>.json    the model, its widths, data and optimizer
    traffic/<traffic>.json   particles, steps a call, chips, sampler keywords
    limits/<cell>.json       the limit of each number the check compares

A new cell adds files; nothing here changes."""

import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


class Cell:
    """One workload of BENCHMARK.json with the files its names point to."""

    def __init__(self, name, root=ROOT, bench_dir=BENCH_DIR):
        self.bench = benchmark(root)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"svgd_bench: no workload {name!r} in "
                             f"BENCHMARK.json (have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = load_json(
            Path(bench_dir) / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(
            Path(bench_dir) / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(Path(bench_dir) / "limits" / f"{name}.json")
        if int(self.traffic["chips"]) != self.chips:
            raise SystemExit(f"svgd_bench: {name}: traffic "
                             f"{self.entry['traffic']!r} is for "
                             f"{self.traffic['chips']} chips, the cell "
                             f"asks for {self.chips}")

    def metrics(self, trace):
        """The cell's metrics for a run: its end-to-end ones, or with
        ``trace`` its per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]
