"""Finding a cell's files by name, and the result line.

Everything that belongs to one configuration, traffic mix, cell, mode or
per-layer metric is a file of its own under ``portbench/``, found by the
name that ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration (its ``model`` block is what
  the harness and the reference read);
- ``traffic/<traffic>.json``: the traffic mix, which names its ``mode``;
- ``workloads/<cell>.json``: the cell's configuration and traffic (as
  ``BENCHMARK.json`` has them) and the limits of its correctness check;
- ``modes/<mode>.py``: the run of a mode;
- ``families/<family>.py``: what a model family's training cells differ in
  (the configuration's ``model.family``, ``portbench/families``);
- ``metrics/<metric>.py``: a per-layer metric's reader.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names a run may not load


class UnknownName(LookupError):
    pass


def _file(kind: str, name: str, suffix: str) -> Path:
    path = HERE / kind / f"{name}{suffix}"
    if not NAME.match(name) or not path.is_file():
        raise UnknownName(f"no {kind[:-1]} named {name!r} (looked for portbench/{kind}/{name}{suffix})")
    return path


def load(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    return json.loads(_file(kind, name, ".json").read_text())


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload_entry(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise UnknownName(f"BENCHMARK.json has no workload named {name!r}")


def cell_spec(bench: dict, name: str) -> dict:
    """The cell's entry and its files: ``{"entry", "cell", "config",
    "traffic"}``; the cell file must name the entry's configuration and
    traffic."""
    entry = workload_entry(bench, name)
    cell = load("workloads", name)
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"portbench/workloads/{name}.json names {cell['config']}, {cell['traffic']}; "
                         f"BENCHMARK.json {entry['config']}, {entry['traffic']}")
    return {"entry": entry, "cell": cell, "config": load("configs", cell["config"]),
            "traffic": load("traffic", cell["traffic"])}


def mode(name: str):
    """The module ``portbench/modes/<name>.py``."""
    _file("modes", name, ".py")
    return importlib.import_module(f"portbench.modes.{name}")


def reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = _file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def process_start() -> float:
    """When this process started, on ``time.time()``'s clock (the kernel's
    count of its start, to 10 ms); now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def result_line(out: dict, bench: dict, workload: str, trace_on: bool, device: dict) -> dict:
    """The last line of a run: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (the cell's end-to-end metrics, or with ``trace_on`` its
    per-layer ones that a reader found), ``device``, with ``trace_on``
    ``breakdown``, and last ``checks``: each compared number with its
    limit."""
    metrics = {}
    if trace_on:
        for entry in bench["per_layer"]:
            if applies(entry, workload) and out.get("run") is not None:
                value = reader(entry["name"])(out["run"])
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        for entry in bench["end_to_end"]:
            if applies(entry, workload):
                if entry["name"] not in out:
                    raise KeyError(f"the mode measured no {entry['name']!r}")
                metrics[entry["name"]] = {"value": out[entry["name"]], "unit": entry["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dict(device)}
    if trace_on:
        line["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": _number(c["value"]), "limit": c["limit"]} for k, c in out["checks"].items()}
    return line
