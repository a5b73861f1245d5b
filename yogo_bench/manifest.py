"""BENCHMARK.json and the files the harness finds by name in it.

  configs/<config>.json   a configuration, named by its `file` entry; its
                          "family" names families/<family>.py
  families/<family>.py    a model family: spec, forward (the plain
                          reference), grid, macs_per_image
  traffic/<mix>.json      a traffic mix; its "driver" names drivers/<driver>.py
  limits/<cell>.json      the cell's checks: {"checks": {name: limit}, ...}
  metrics/<metric>.py     a per-layer metric's reader, `read(ctx)`; the
                          program_span and program_counter readers read
                          yogo_tpu_torch/utils/tracing.py's window record
                          through program.py

A later change adds a configuration, mix, cell or metric by adding files
and entries; no file here needs an edit for it. A configuration of a new
architecture adds families/<family>.py beside its config, its limits file
and its entries. `validate` holds a manifest to the benchmark's contract
(names, units, keys, sizes, references, a family module for each
configuration).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(man: dict, workload: str) -> dict:
    return _by_name(man["workloads"], workload, "workload")


def config(man: dict, name: str) -> dict:
    """The configuration file of `name`; a `checkpoint` path in it is taken
    relative to the checkout's root."""
    cfg = json.loads((ROOT / _by_name(man["configs"], name, "config")["file"]).read_text())
    if cfg.get("checkpoint"):
        cfg["checkpoint"] = str(ROOT / cfg["checkpoint"])
    return cfg


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


def driver(mix: dict) -> ModuleType:
    return importlib.import_module(f"yogo_bench.drivers.{mix['driver']}")


def family(name: str) -> ModuleType:
    """families/<name>.py: a model family's spec, forward, grid and MACs."""
    return importlib.import_module(f"yogo_bench.families.{name}")


def _for(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(man: dict, workload: str) -> List[dict]:
    return [m for m in man["end_to_end"] if _for(m, workload)]


def per_layer(man: dict, workload: str) -> List[dict]:
    return [m for m in man["per_layer"] if _for(m, workload)]


def reader(name: str) -> ModuleType:
    """metrics/<name>.py, loaded by path (a metric's name has dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"yogo_bench.metrics.{name}", path)
    if spec is None or not path.exists():
        raise KeyError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _text(v, what: str, problems: list) -> None:
    if not isinstance(v, str) or not 1 <= len(v) <= 200 or "\n" in v or "\t" in v:
        problems.append(f"{what}: 1 to 200 characters on one line, no tab")


def validate(man: dict, root: Path = ROOT) -> List[str]:
    """The contract's rules that a file can be held to; [] when it keeps them."""
    p: List[str] = []
    if set(man) != KEYS["top"]:
        p.append(f"top-level keys {sorted(man)}")
    cmd = man.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        p.append("command: 1 to 32 strings")
    for word in cmd:
        _text(word, "command word", p)
    paths = man.get("paths", [])
    if not 1 <= len(paths) <= 16 or any(not PATH.match(x) or x.startswith("/") or ".." in x for x in paths):
        p.append("paths: 1 to 16 relative paths of [A-Za-z0-9_.-/]")
    rs = man.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        p.append("run_seconds: a whole number from 1 to 51")
    names = {}
    for kind, key in (("configs", "config"), ("workloads", "workload"),
                      ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        optional = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        for e in man.get(kind, []):
            if not KEYS[key] <= set(e) <= KEYS[key] | optional:
                p.append(f"{kind} {e.get('name')}: keys {sorted(e)}")
            n = e.get("name", "")
            if not NAME.match(n):
                p.append(f"{kind}: bad name {n!r}")
            if n in names.get(kind, set()):
                p.append(f"{kind}: {n} twice")
            names.setdefault(kind, set()).add(n)
    if not 1 <= len(man.get("configs", [])) <= 24:
        p.append("configs: 1 to 24")
    if not 1 <= len(man.get("workloads", [])) <= 24:
        p.append("workloads: 1 to 24")
    if not 1 <= len(man.get("end_to_end", [])) <= 16:
        p.append("end_to_end: 1 to 16")
    if not 1 <= len(man.get("per_layer", [])) <= 128:
        p.append("per_layer: 1 to 128")
    files = set()
    for c in man.get("configs", []):
        _text(c.get("source"), f"config {c['name']} source", p)
        _text(c.get("why"), f"config {c['name']} why", p)
        f = c.get("file", "")
        if not any(f.startswith(x.rstrip("/") + "/") for x in paths) or f in files or not (root / f).exists():
            p.append(f"config {c['name']}: file {f!r} not a file of its own under paths")
        files.add(f)
        if (root / f).is_file():
            fam = json.loads((root / f).read_text()).get("family")
            if not (isinstance(fam, str) and fam.isidentifier()
                    and (root / HERE.name / "families" / f"{fam}.py").is_file()):
                p.append(f"config {c['name']}: family {fam!r} has no families/<family>.py")
        if len(c.get("reduced", [])) > 16 or any(not NAME.match(k) for k in c.get("reduced", [])):
            p.append(f"config {c['name']}: reduced")
    pairs, four = set(), 0
    for w in man.get("workloads", []):
        _text(w.get("why"), f"workload {w['name']} why", p)
        if w.get("config") not in names.get("configs", set()):
            p.append(f"workload {w['name']}: unknown config")
        if not NAME.match(str(w.get("traffic", ""))):
            p.append(f"workload {w['name']}: bad traffic name")
        if (w.get("config"), w.get("traffic")) in pairs:
            p.append(f"workload {w['name']}: config and traffic twice")
        pairs.add((w.get("config"), w.get("traffic")))
        if w.get("chips") not in (1, 4):
            p.append(f"workload {w['name']}: chips 1 or 4")
        four += w.get("chips") == 4
    if four > max(1, len(man.get("workloads", [])) // 4):
        p.append("too many cells on four chips")
    used = {w.get("config") for w in man.get("workloads", [])}
    if used != names.get("configs", set()):
        p.append("a configuration that no cell uses")
    cells = names.get("workloads", set())
    e2e = names.get("end_to_end", set())
    for m in man.get("end_to_end", []) + man.get("per_layer", []):
        if not UNIT.match(str(m.get("unit", ""))):
            p.append(f"metric {m['name']}: bad unit")
        if m.get("better") not in ("lower", "higher"):
            p.append(f"metric {m['name']}: better")
        if not set(m.get("workloads", [])) <= cells or ("workloads" in m and not m["workloads"]):
            p.append(f"metric {m['name']}: workloads")
    for m in man.get("end_to_end", []):
        if m.get("source") not in E2E_SOURCES:
            p.append(f"metric {m['name']}: source")
        b = m.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            p.append(f"metric {m['name']}: bound")
    if "setup_s" not in e2e:
        p.append("no setup_s")
    for m in man.get("per_layer", []):
        if m.get("source") not in SOURCES:
            p.append(f"metric {m['name']}: source")
        _text(m.get("layer"), f"metric {m['name']} layer", p)
        if m.get("moves") not in e2e:
            p.append(f"metric {m['name']}: moves an unknown metric")
        mv = _by_name(man["end_to_end"], m["moves"], "metric") if m.get("moves") in e2e else {}
        for w in m.get("workloads", sorted(cells)):
            if not _for(mv, w):
                p.append(f"metric {m['name']}: cell {w} does not report {m['moves']}")
    for w in cells:
        if len(end_to_end(man, w)) < 2 or not per_layer(man, w):
            p.append(f"cell {w}: needs setup_s, another end-to-end metric and a per-layer one")
    if len(json.dumps(man)) > 64 * 1024:
        p.append("BENCHMARK.json over 64 KiB")
    return p
