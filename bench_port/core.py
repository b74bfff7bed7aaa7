"""Where the benchmark finds what a cell needs, by the names in
``BENCHMARK.json``.

- a configuration: the ``file`` of its entry in ``configs``;
- a traffic mix: ``traffic/<name>.json`` beside this file;
- a metric: its reader ``metrics/<name>.py``, a function ``read(record)``
  that returns the value, or None where the record holds nothing to read;
- a layer's kernel names: the union of the ``patterns`` (regular
  expressions searched in a kernel's name) of every ``layers/<layer>.*.json``;
  a kernel that the patterns of two layers match is an error, so a new
  layer's file adds a metric and never moves a kernel out of an old one;
- a configuration's limits: ``limits/<config>.json``.

A later cell, mix, metric or kernel name therefore comes in as a new file,
and no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str, root: Path = ROOT,
         here: Path = HERE) -> dict:
    """Everything one cell runs with: its workload entry, its
    configuration's file, its traffic mix, its limits and its metrics
    (end-to-end and per-layer) as BENCHMARK.json lists them."""
    w = _named(bench["workloads"], name, "workload")
    c = _named(bench["configs"], w["config"], "configuration")
    return {
        "workload": w,
        "config": json.loads((root / c["file"]).read_text()),
        "traffic": json.loads(
            (here / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads(
            (here / "limits" / f"{w['config']}.json").read_text()),
        "end_to_end": applying(bench["end_to_end"], name),
        "per_layer": applying(bench["per_layer"], name),
    }


def applying(metrics: list[dict], cell_name: str) -> list[dict]:
    """The metrics that a cell reports: those with no ``workloads`` key
    and those that list it."""
    return [m for m in metrics if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def layer_patterns(here: Path = HERE) -> dict[str, list[str]]:
    """{layer: its patterns}, the union over ``layers/<layer>.*.json``."""
    out: dict[str, list[str]] = {}
    for path in sorted((here / "layers").glob("*.json")):
        layer = path.name.split(".")[0]
        out.setdefault(layer, []).extend(
            json.loads(path.read_text())["patterns"])
    return out


def layer_of(kernel: str, patterns: dict[str, list[str]]) -> str | None:
    """The layer whose patterns match ``kernel``; None where no layer
    claims it.  Raises ValueError where two layers claim it."""
    hits = [layer for layer in sorted(patterns)
            if any(re.search(p, kernel) for p in patterns[layer])]
    if len(hits) > 1:
        raise ValueError(f"kernel {kernel!r} is claimed by the layers "
                         f"{', '.join(hits)}: their pattern files overlap")
    return hits[0] if hits else None


def read_metrics(entries: list[dict], record: dict,
                 here: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read in ``record``."""
    out = {}
    for m in entries:
        value = reader(m["name"], here)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def layer_ops(record: dict, layer: str | None) -> dict[str, float] | None:
    """{name: device seconds} in the profiled solve of the operations that
    ``layer`` claims (None: that no layer claims); None without a
    profile."""
    prof = record.get("profile")
    if prof is None:
        return None
    return {name: s for name, s in prof["device_s"].items()
            if layer_of(name, record["layers"]) == layer}


def layer_seconds(record: dict, layer: str | None) -> float | None:
    """Device seconds in the profiled solve of the operations that
    ``layer`` claims (None: that no layer claims); None without a
    profile."""
    ops = layer_ops(record, layer)
    return None if ops is None else sum(ops.values())
