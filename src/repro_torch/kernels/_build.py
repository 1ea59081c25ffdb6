"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``build/`` at the repository root. A
library's name carries a hash of its source and flags, so an edited kernel is
rebuilt and an unchanged one is reused. A missing ``nvcc`` or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

SOURCES = {
    "flash_attention": "flash_attention.cu",
    "paged_decode": "paged_decode.cu",
    "ssd_scan": "ssd_scan.cu",
    "rglru_scan": "rglru_scan.cu",
    "moe_gather": "moe_gather.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
BUILD_TIMEOUT_S = 600
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"  # the toolkit's default place, when nvcc is not on PATH

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

_loaded: dict[str, ctypes.CDLL] = {}


@dataclass
class BuildReport:
    name: str
    path: Path
    seconds: float  # wall time of this build; 0.0 when the library was already built
    ptxas: str  # nvcc's -Xptxas -v output ("" when already built)

    def resources(self) -> list[str]:
        """One line per compiled kernel: registers, spills and static shared memory."""
        out, fn = [], None
        for line in self.ptxas.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers.*", line)
            if m and fn:
                out.append(f"{fn}: {m.group(0)}")
            if "spill" in line and fn and "0 bytes spill stores, 0 bytes spill loads" not in line:
                out.append(f"{fn}: {line.strip()}")
        return out


def nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from csrc/ at first use")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, BuildReport]:
    """Build the named kernels (all by default) that are not built yet, one
    ``nvcc`` per source, all started together."""
    names = list(SOURCES) if names is None else names
    reports: dict[str, BuildReport] = {}
    procs = {}
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                reports[name] = BuildReport(name, out, 0.0, "")
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
            os.replace(tmp, out)  # atomic: another process never loads a half-written library
            reports[name] = BuildReport(name, out, time.perf_counter() - t0, log)
    finally:
        for proc, tmp, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _loaded[name] = lib
    return lib
