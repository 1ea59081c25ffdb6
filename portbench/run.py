"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one run of
one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch`` beside
``BENCHMARK.json``. The cell's files are found by name (``portbench/
harness.py``), its mode runs it on the card, and the last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks``, each number of the correctness check with its limit, which are
also the last lines on standard error.

Exit codes: 0 a result was printed; 2 an unknown name or argument; 3 no CUDA
card, or fewer than the cell asks for; 4 JAX or the JAX package was loaded;
5 the port is not beside the benchmark. Only 0 prints a result.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)  # the package is imported as portbench, from the checkout's root
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

STARTED = harness.process_start()
CACHE = ROOT / "build" / "portbench"  # fixed, inside the checkout; the port's nvcc builds go to build/


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        bench = harness.benchmark(ROOT)
        spec = harness.cell_spec(bench, args.workload)
        mode = harness.mode(spec["traffic"]["mode"])
    except (harness.UnknownName, FileNotFoundError) as e:
        log(f"portbench: {e}")
        return 2
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)

    import torch

    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: {args.workload} needs {chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"portbench: no port at {ROOT / 'src' / 'repro_torch'}; the benchmark measures it from its checkout")
        return 5

    out = mode.run(spec, args.seed, args.seconds, bool(args.trace), "cuda", STARTED, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"portbench: the run loaded JAX or the JAX package: {found}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = harness.result_line(out, bench, args.workload, bool(args.trace), device)
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
