"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) resolves to:
- its configuration: the file that `configs` names for it, JSON, with the
  plain reference module beside it (`reference` in that file);
- its traffic mix: `benchmark/traffic/<traffic>.json`;
- its comparison's sample sizes and limits: `benchmark/checks/<workload>.json`;
- its metrics: every end-to-end metric, and every per-layer metric whose
  `workloads` lists the cell or, without that key, that moves an end-to-end
  metric the cell reports; each read by `benchmark/metrics/<name>.py`.

So a new cell, configuration, traffic mix or metric is new files and an
entry in BENCHMARK.json, and no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def problems(spec: dict) -> list[str]:
    """What in `spec` breaks the benchmark's format: names, units, lines,
    keys and cross references (empty when it is sound)."""
    out = []
    if set(spec) != TOP_KEYS:
        out.append(f"top-level keys {sorted(spec)}")
    for word in spec.get("command", []):
        if not _line(word):
            out.append(f"command word {word!r}")
    for p in spec.get("paths", []):
        if not PATH.fullmatch(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    names = {}
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for entry in spec.get(group, []):
            extra = set(entry) - keys - ({"workloads"} if group in ("end_to_end", "per_layer")
                                         else set())
            if extra or not keys <= set(entry):
                out.append(f"{group} entry {entry.get('name')!r}: keys {sorted(entry)}")
            name = entry.get("name", "")
            if not NAME.fullmatch(str(name)):
                out.append(f"{group} name {name!r}")
            kind = "metric" if group in ("end_to_end", "per_layer") else group
            if (kind, name) in names:
                out.append(f"duplicate {kind} {name!r}")
            names[(kind, name)] = entry
            if "unit" in entry and not UNIT.fullmatch(str(entry["unit"])):
                out.append(f"unit {entry['unit']!r} of {name!r}")
            if "better" in entry and entry["better"] not in ("lower", "higher"):
                out.append(f"better {entry['better']!r} of {name!r}")
            if "source" in entry and group in ("end_to_end", "per_layer") \
                    and entry["source"] not in SOURCES:
                out.append(f"source {entry['source']!r} of {name!r}")
            for key in ("why", "layer") + (("source",) if group == "configs" else ()):
                if key in entry and not _line(entry[key]):
                    out.append(f"{key} of {name!r}")
            for key in ("config", "traffic"):
                if key in entry and not NAME.fullmatch(str(entry[key])):
                    out.append(f"{key} {entry[key]!r} of {name!r}")
            for key in entry.get("reduced", []):
                if not NAME.fullmatch(str(key)):
                    out.append(f"reduced key {key!r} of {name!r}")
    configs = {c["name"] for c in spec.get("configs", [])}
    cells = {w["name"] for w in spec.get("workloads", [])}
    e2e = {m["name"] for m in spec.get("end_to_end", [])}
    for w in spec.get("workloads", []):
        if w.get("config") not in configs:
            out.append(f"workload {w.get('name')!r}: no configuration {w.get('config')!r}")
    for m in spec.get("end_to_end", []) + spec.get("per_layer", []):
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"metric {m['name']!r}: no workload {cell!r}")
    for m in spec.get("per_layer", []):
        if m.get("moves") not in e2e:
            out.append(f"metric {m['name']!r} moves {m.get('moves')!r}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path

    def reference_module(self):
        """The configuration's plain reference, the module beside its file."""
        return load_module(self.bench_dir / "configs" / self.config["reference"],
                           f"benchmark_config_{self.config_name}")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def resolve(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload`, with every file it needs read."""
    bench_dir = root / "benchmark"
    try:
        w = next(w for w in spec["workloads"] if w["name"] == workload)
    except StopIteration:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json") from None
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload, {m["name"]})]
    reported = {m["name"] for m in e2e}
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=json.loads((root / entry["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        check=json.loads((bench_dir / "checks" / f"{workload}.json").read_text()),
        end_to_end=e2e,
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload, reported)],
        bench_dir=bench_dir,
    )


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(cell: Cell, name: str):
    """`read(run) -> float | None` of `benchmark/metrics/<name>.py`."""
    return load_module(cell.bench_dir / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read
