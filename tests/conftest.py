import os

# Smoke tests and benches must see the REAL device count (1 CPU); only
# launch/dryrun.py sets the 512-device flag (and only in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import importlib.util
import warnings

import pytest

# Seed gap: some test modules need deps this container doesn't have
# (`hypothesis` is not installed). Gate them at collection so the rest of
# the suite still runs — remove entries as the gaps are filled in.
# (`repro.dist` was restored in PR 2; its former gate entries are gone.)
_GATED = {
    "hypothesis": ["test_optimizer.py", "test_serving.py"],
}
collect_ignore = []
for _mod, _files in _GATED.items():
    try:
        _found = importlib.util.find_spec(_mod) is not None
    except ModuleNotFoundError:
        _found = False
    if not _found:
        collect_ignore.extend(_files)
        warnings.warn(f"skipping {_files}: module {_mod!r} unavailable")


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one); run with -m gpu")


@pytest.fixture()
def tmp_db_dir(tmp_path):
    return str(tmp_path / "db")
