"""``BENCHMARK.json`` and the files it names, found by name, and the
manifest's own check: the characters of every name and unit, that each
per-layer metric lists its cells and each of those reports the end-to-end
metric it moves, and that every layer of each configuration is of a kind
that its module of layer kinds or the harness's own code defines."""
from __future__ import annotations

import json
import re
from pathlib import Path

from . import weights as W

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = Path(__file__).resolve().parent


class Bench:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def check(self, cell: str) -> dict:
        return json.loads((HERE / "workloads" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e
                                 else [])]

    def reader(self, metric: str):
        return reader(metric)


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    import importlib.util
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(bench: Bench) -> list:
    """What is wrong with the manifest and the files it names ([] if
    nothing)."""
    d, out = bench.data, []
    if not (isinstance(d.get("run_seconds"), int) and 1 <= d["run_seconds"] <= 51):
        out.append(f"run_seconds {d.get('run_seconds')!r}: a whole number 1-51")
    for m in d["end_to_end"]:
        if not 0 < m.get("bound", 0) <= 0.25:
            out.append(f"{m['name']}: bound {m.get('bound')!r} not in (0, 0.25]")
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: source {m['source']!r}")
    if "setup_s" not in {m["name"] for m in d["end_to_end"]}:
        out.append("no setup_s")
    for w in d["workloads"]:
        if w["chips"] not in (1, 4) or not 1 <= len(w["why"]) <= 200:
            out.append(f"{w['name']}: chips {w['chips']} / why of "
                       f"{len(w['why'])} characters")
    named = [("config", c["name"]) for c in d["configs"]] \
        + [("workload", w["name"]) for w in d["workloads"]] \
        + [("traffic", w["traffic"]) for w in d["workloads"]] \
        + [("config of a workload", w["config"]) for w in d["workloads"]] \
        + [("metric", m["name"]) for m in d["end_to_end"] + d["per_layer"]] \
        + [("reduced key", k) for c in d["configs"] for k in c["reduced"]]
    out += [f"{kind} name {n!r}" for kind, n in named if not NAME.match(n)]
    out += [f"unit {m['unit']!r} of {m['name']}" for m in
            d["end_to_end"] + d["per_layer"] if not UNIT.match(m["unit"])]
    for group in ("configs", "workloads"):
        names = [x["name"] for x in d[group]]
        out += [f"{group}: {n} twice" for n in set(names)
                if names.count(n) > 1]
    metrics = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    out += [f"metric {n} twice" for n in set(metrics) if metrics.count(n) > 1]
    configs = {c["name"] for c in d["configs"]}
    for w in d["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: no config {w['config']}")
        if not (HERE / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"{w['name']}: no traffic file {w['traffic']}")
        if not (HERE / "workloads" / f"{w['name']}.json").is_file():
            out.append(f"{w['name']}: no workloads/{w['name']}.json")
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"{w['name']}: needs setup_s and another end-to-end "
                       "metric")
        if not bench.per_layer(w["name"]):
            out.append(f"{w['name']}: no per-layer metric")
    for c in d["configs"]:
        path = bench.root / c["file"]
        if not path.is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
            continue
        out += [f"config {c['name']}: {p}"
                for p in W.kind_problems(json.loads(path.read_text()))]
    cells = {w["name"] for w in d["workloads"]}
    for m in d["per_layer"]:
        if "workloads" not in m:
            out.append(f"{m['name']}: lists no cells")
            continue
        for cell in m["workloads"]:
            if cell not in cells:
                out.append(f"{m['name']}: no cell {cell}")
            elif m["moves"] not in {e["name"] for e in bench.end_to_end(cell)}:
                out.append(f"{m['name']}: {cell} does not report {m['moves']}")
        if not (HERE / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no metrics/{m['name']}.py")
    return out
