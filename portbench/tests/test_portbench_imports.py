"""What a run loads: nothing whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package), in a process of its own; the
reference nothing of the port either."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

MODES = sorted({harness.load("traffic", w["traffic"])["mode"] for w in harness.benchmark()["workloads"]})
RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from portbench import harness
from portbench.tests.small import small_cell
bench = harness.benchmark()
cell = next(w["name"] for w in bench["workloads"] if harness.load("traffic", w["traffic"])["mode"] == {mode!r})
spec, cfg = small_cell(cell)
out = harness.mode({mode!r}).run(spec, 3, 0.05, True, "cpu", time.time(), cfg=cfg, log=lambda *a: None)
harness.result_line(out, bench, cell, True, {{}})
print(json.dumps(harness.forbidden_modules()))
"""
REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import portbench.reference.model, portbench.reference.mamba2, portbench.reference.train
print(json.dumps(sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "repro", "repro_torch"))))
"""


def _loaded(code: str) -> list:
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", MODES)
def test_a_run_loads_no_jax_and_no_jax_package(mode):
    code = RUN.format(root=str(harness.ROOT), src=str(harness.ROOT / "src"), mode=mode)
    assert _loaded(code) == []


def test_the_reference_loads_nothing_of_the_program():
    assert _loaded(REFERENCE.format(root=str(harness.ROOT))) == []
