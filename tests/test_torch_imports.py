"""The port stands alone: importing it (and chip_smoke.py) pulls in neither
JAX nor the reference package, nor msgpack or ml_dtypes (the card's machine
has neither), and its entry points default to CUDA."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import flatten, params_from_jax, tensor_from_numpy
from repro_torch.device import resolve_device
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.serving.kv_cache import PagedKVCache

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke  # its imports only: the phases run under __main__
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes"))
print("imported:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# the storage engine and its harnesses run on the card's machine on their own
STORAGE_MODULES = ["repro_torch.core", "repro_torch.configs.bvlsm_paper", "repro_torch.testing",
                   "repro_torch.testing.model_db", "repro_torch.testing.crash_harness",
                   "repro_torch.testing.failover_harness"]

_STORAGE_PROBE = """
import importlib, sys
sys.path[:0] = [{src!r}]
mod = importlib.import_module({module!r})
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print("imported:", bad)
sys.exit(1 if bad or not mod.__name__.startswith("repro_torch") else 0)
"""


@pytest.mark.parametrize("module", STORAGE_MODULES)
def test_storage_modules_load_neither_jax_reference_nor_msgpack(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _STORAGE_PROBE.format(src=str(ROOT / "src"), module=module)
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_core_exports_every_name_of_the_reference():
    import repro.core as ref_core
    import repro_torch.core as port_core

    assert set(ref_core.__all__) <= set(port_core.__all__)
    for name in ref_core.__all__:
        assert getattr(port_core, name).__module__.startswith("repro_torch"), name


def test_port_sources_name_neither_jax_nor_reference():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "repro", "msgpack", "ml_dtypes"), f"{path}: {line}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is usable")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-4b", "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config("qwen3-4b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(4, 8, n_layers=1, n_kv_heads=1, head_dim=8, max_pages_per_seq=2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_main_on_cpu(capsys):
    m = serve.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "8", "--max-new", "4", "--max-batch", "2"])
    assert (m["requests"], m["tokens"], m["prefill_calls"], m["decode_calls"]) == (3, 12, 3, 9)
    assert "served:" in capsys.readouterr().out


def test_convert_bf16_and_key_paths():
    import ml_dtypes  # comes with the reference's stack; the port itself never imports it

    a = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    t = tensor_from_numpy(a.astype(ml_dtypes.bfloat16))
    assert t.dtype == torch.bfloat16 and torch.equal(t, torch.from_numpy(a).bfloat16())
    tree = {"attn": {"wq": 1, "q_norm": 2}, "ln1": 3}
    assert flatten(tree) == {"attn.wq": 1, "attn.q_norm": 2, "ln1": 3}


def test_convert_list_trees():
    """The hybrid family's tree holds lists of per-slot dicts: a list index
    is a ``ModuleList`` index in the ``state_dict`` key, and
    ``params_from_jax`` keeps the lists."""
    a, b = np.ones((1, 2), np.float32), np.zeros((1, 3), np.float32)
    tree = {"slots": [{"mix": {"w_in": a}}, {"ln1": b}], "rem": [], "ln_f": b[0]}
    converted = params_from_jax(tree)
    assert isinstance(converted["slots"], list) and converted["rem"] == []
    flat = flatten(converted)
    assert list(flat) == ["slots.0.mix.w_in", "slots.1.ln1", "ln_f"]
    assert torch.equal(flat["slots.0.mix.w_in"], torch.ones(1, 2))
    assert flatten(tree)["slots.1.ln1"] is b
