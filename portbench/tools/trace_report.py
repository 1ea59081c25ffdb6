"""Where a traced run's step goes, by the program's own spans
(``portbench/spans.py``), on the card:

    python3 portbench/tools/trace_report.py --workload <cell> --seed <n> [--seconds 45] \
        [--out <file>.json]

One run of the cell as ``run.py --trace 1`` makes it (set-up, the window,
the two profiles, the reference), then: its result line; the device ms a
step of each span of a layer's parts (its forward, recompute and tied
backward nodes, as ``Spans.layer_ms``: the MoE's parts, ``ssd.backward``),
of ``forward``, ``backward``, the remat recompute, ``clip``, ``optimizer``
and the whole step; of each of the benchmark's ranges
(``portbench.<range>``: the optimizer update and the family's, such as
``ssd_backward``); each span's
busiest kernels; the program's counters; and the device's idle gaps by the
innermost span open at each. The last line of standard output is the same
as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness, spans, timeline  # noqa: E402

STARTED = harness.process_start()
PHASES = ("train_step", "microbatch", "forward", "backward", "clip", "optimizer", "layer")  # in phase_ms


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def top(s, ops, n: int = 3) -> list[list]:
    """[[kernel name, ms a step], …]: the ``n`` kernels of most device time
    that ``ops`` launched."""
    by = defaultdict(float)
    for d in s.launched_by(ops):
        by[d.name[:80]] += d.time_range.elapsed_us() / 1e3 / s.steps
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def report(run) -> dict:
    """The spans' reading of a traced run (``portbench.modes.train.TraceRun``)."""
    from repro_torch import trace

    s = spans.of(run)
    if s is None:
        raise ValueError("the run's trace holds no repro_torch.train_step span")
    return {
        "steps": s.steps,
        "span_ms": {name: s.layer_ms(name) for name in sorted(s.spans) if name not in PHASES},
        "phase_ms": {"forward": s.device_ms(s.inside("forward")), "backward": s.device_ms(s.during("backward")),
                     "recompute": s.device_ms(s.recompute()),
                     "clip": s.device_ms(s.inside("clip")), "optimizer": s.device_ms(s.inside("optimizer")),
                     "step": s.device_ms(s.during(spans.STEP))},
        "range_ms": {name: timeline.device_us(run.timeline.in_range(name)) / 1e3 / s.steps
                     for name in getattr(run, "ranges", ())},
        "span_kernels": {name: top(s, s.inside(name) + s.backward_of(name)) for name in sorted(s.spans)
                         if name not in PHASES},
        "unlaunched": sum(v is None for v in s.launcher.values()),
        "counters": trace.counters(),
        "idle_gaps": s.idle_gaps(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch

    bench = harness.benchmark(ROOT)
    spec = harness.cell_spec(bench, args.workload)
    out = harness.mode(spec["traffic"]["mode"]).run(spec, args.seed, args.seconds, True, "cuda", STARTED, log=log)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"line": harness.result_line(out, bench, args.workload, True, device), **report(out["run"])}
    for key in ("span_ms", "phase_ms", "range_ms", "counters"):
        log(f"{key}: " + ", ".join(f"{k} {v:.3f}" for k, v in result[key].items()))
    log(f"idle gaps by span: {result['idle_gaps']}; device events with no launching call: {result['unlaunched']}")
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
