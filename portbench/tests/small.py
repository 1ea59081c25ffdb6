"""Small cells for the CPU tests: a configuration's model block and a traffic
mix cut to sizes a test run holds, and the port's config of the same size."""
from __future__ import annotations

import dataclasses

from portbench import families, harness
from portbench.modes.train import model_block

CONFIGS = sorted(p.stem for p in (harness.HERE / "configs").glob("*.json"))  # every configuration file


def small_cell(workload: str, dtype: str = "bfloat16", seq: int = 16, **traffic):
    """(spec, port config) of ``workload`` at the port's reduced size (2
    layers, d 64, vocab 256; 4 experts top-2; SSD state 16, heads of 16,
    chunk 32) in ``dtype``, its traffic at
    ``seq`` tokens a row and ``traffic``'s other changes."""
    return _small(harness.cell_spec(harness.benchmark(), workload), dtype, seq, traffic)


def small_config(config: str, mix: str = "train.b4x512", dtype: str = "bfloat16", seq: int = 16, **traffic):
    """The same of configuration ``config`` under traffic ``mix``, whether or
    not a cell of ``BENCHMARK.json`` pairs them: a cell with no limits."""
    cell = {"config": config, "traffic": mix, "limits": {}}
    spec = {"entry": None, "cell": cell, "config": harness.load("configs", config), "traffic": harness.load("traffic", mix)}
    return _small(spec, dtype, seq, traffic)


def _small(spec: dict, dtype: str, seq: int, traffic: dict):
    from repro_torch.configs import get_config

    m = spec["config"]["model"]
    cfg = dataclasses.replace(get_config(m["arch"]).reduced(), dtype=dtype)
    spec["config"] = {**spec["config"], "model": {"arch": m["arch"], **model_block(cfg, families.of(m))}}
    spec["traffic"] = {**spec["traffic"], "seq": seq, **traffic}
    return spec, cfg
