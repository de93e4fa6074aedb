"""BENCHMARK.json and the files it names, found by name.

- `workloads/<cell>.json`: the cell ({"config", "traffic", "chips",
  "trace_units", "limits"});
- `configs/<config>.json`: the model configuration as it is run; its
  "field" key (absent: "field") names its field module;
- `reference/<field>.py`: the field module, the plain reference of what
  differs between field architectures, and their operation counts
  (reference/__init__.py gives its interface);
- `traffic/<traffic>.json`: the mix the one generator (harness/scene.py)
  and the cell's entry read ({"entry", ...});
- `entries/<entry>.py`: what drives the program for that kind of cell;
- `metrics/<metric>.py`: one per-layer metric's reader, `read(ctx)`.
Adding a cell, a configuration (of a field architecture the benchmark has
or of a new one, with its field module), a traffic mix or a metric adds
files and entries in BENCHMARK.json; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(bench_dir: Path = BENCH_DIR) -> dict:
    """BENCHMARK.json beside the benchmark's folder."""
    return load_json(bench_dir.parent / "BENCHMARK.json")


def _one(items: list, name: str, what: str) -> dict:
    found = [x for x in items if x["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether `metric` is reported in `cell`: listed in its `workloads`, or,
    without that key, wherever its `moves` (a per-layer metric) is reported
    (`reported`: the cell's end-to-end metrics) or everywhere (end-to-end)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def field_module(config: dict, bench_dir: Path = BENCH_DIR):
    """reference/<stem>.py, the field module that the configuration's
    "field" key names ("field", TensoRF-VM, where it has none). It is loaded
    as a module of the reference package, so it may import the shared
    parts relatively (`from .field import density, rounder`)."""
    stem = config.get("field", "field")
    if not NAME.match(stem) or "." in stem:
        raise ValueError(f"field {stem!r} is not a module name")
    return load_module(bench_dir / "reference" / f"{stem}.py", f"reference.{stem}")


def cell_spec(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """Everything a run of cell `name` reads: its BENCHMARK.json entry, its
    cell, config and traffic files, the configuration's field module, its
    end-to-end and per-layer metrics."""
    man = manifest(bench_dir)
    entry = _one(man["workloads"], name, "workload")
    cell = load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {cell[key]!r}, BENCHMARK.json {entry[key]!r}")
    config_entry = _one(man["configs"], entry["config"], "config")
    e2e = [m for m in man["end_to_end"] if applies(m, name)]
    reported = {m["name"] for m in e2e}
    config = load_json(bench_dir.parent / config_entry["file"])
    return {
        "name": name,
        "bench_dir": bench_dir,
        "entry": entry,
        "cell": cell,
        "config": config,
        "field": field_module(config, bench_dir),
        "traffic": load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        "end_to_end": e2e,
        "per_layer": [m for m in man["per_layer"] if applies(m, name, reported)],
        "run_seconds": man["run_seconds"],
    }


def load_module(path: Path, name: str):
    """Import the Python file `path` as module `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(kind: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "entries" / f"{kind}.py", f"bench_entry_{kind}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """metrics/<name>.py's `read`."""
    mod = load_module(bench_dir / "metrics" / f"{name}.py", "bench_metric_" + re.sub(r"\W", "_", name))
    return mod.read


def problems(man: dict) -> list[str]:
    """What in BENCHMARK.json breaks the benchmark's naming rules or
    cross-references (names, units, sources, each metric's cells reporting
    its `moves`)."""
    out = []
    cells = {w["name"]: w for w in man["workloads"]}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in man[key]]
    names += [w[k] for w in man["workloads"] for k in ("config", "traffic")]
    names += [k for c in man["configs"] for k in c["reduced"]]
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in man[key]]
        out += [f"{key}: {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
        allowed = E2E_SOURCES if m["name"] in e2e else SOURCES
        if m["source"] not in allowed:
            out.append(f"{m['name']}: source {m['source']!r}")
        out += [f"{m['name']}: unknown cell {c!r}" for c in m.get("workloads", []) if c not in cells]
    for m in man["per_layer"]:
        moves = e2e.get(m["moves"])
        if moves is None:
            out.append(f"{m['name']}: moves unknown metric {m['moves']!r}")
            continue
        out += [f"{m['name']}: cell {c!r} does not report {m['moves']}" for c in m.get("workloads", cells)
                if not applies(moves, c)]
    if "setup_s" not in e2e:
        out.append("no setup_s")
    return out
