"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size, in one process:

    python3 portbench/tools/readings.py --workload <cell> --seeds 12 --first-seed <n> \
        [--control 3] [--fault half_batch --fault-seeds 3] [--out chiprun_out/<file>.jsonl]

For each of ``--seeds`` seeds from ``--first-seed``, a run of the cell as
``run.py`` makes it (set-up, a one-second window, the reference) and its
numbers (``portbench/check.py``): the lower readings. For the first
``--control`` seeds, the control (the family's reference,
``portbench/reference/model.py`` or ``mamba2.py``, with ``precision="fp8"``:
bf16 activations and fp8 products) in the program's
place, against an fp32 reference run of its own (:func:`control`): the
upper readings (``--seeds 0``: the
control alone). With ``--fault half_batch``, the program with half of each
batch left out (the mean taken over the rest) on ``--fault-seeds`` seeds.
Each reading is judged as a run judges it (``portbench/check.py::judge``)
against the limits that the cell's ``portbench/workloads/<cell>.json``
holds, and its line carries that verdict, ``correct``. One JSON line per
reading, and a summary line per kind with how many came out correct.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import check, harness, weights  # noqa: E402
from portbench.modes import train  # noqa: E402
from portbench.reference import train as reference  # noqa: E402


def half_batch(ts):
    """``accumulate_grads`` over the first half of the rows (of the positions,
    for a batch of one row): the fault of a step that leaves half out."""
    orig = ts.accumulate_grads

    def faulty(model, params, batch, cfg):
        rows = batch["tokens"].shape[0]
        cut = {k: (v[: rows // 2] if rows > 1 else v[:, : v.shape[1] // 2]) for k, v in batch.items()}
        return orig(model, params, cut, cfg)

    return orig, faulty


def follow(spec: dict, seed: int, precision: str, dev, **kw) -> dict:
    """The reference's checked steps of the cell ``spec`` from ``seed``'s
    weights and batches, in ``precision`` ("fp32", or the control's "fp8"),
    in segments that grow as inside a run; ``kw`` as
    :func:`portbench.reference.train.follow` takes them."""
    from repro_torch.launch.train import train_allocator

    m, traffic = spec["config"]["model"], spec["traffic"]
    batches = train.generator.TokenBatches(traffic, m["vocab"], seed)
    with train_allocator(dev):
        return reference.follow(m, traffic, lambda i: weights.draw(m, seed, i, dev),
                                [batches.batch(i) for i in range(train.CHECKED_STEPS)], dev, precision=precision,
                                **kw)


def control(spec: dict, seed: int, dev) -> tuple[dict, dict]:
    """(control, reference): the control's readings in the program's place,
    and the fp32 reference's held against them, its step-1 direction
    included."""
    ctrl = follow(spec, seed, "fp8", dev, keep_first=True)
    return ctrl, follow(spec, seed, "fp32", dev, against=ctrl.pop("first_unit"))


def worst_dir(ref: dict, n: int = 3) -> list:
    """The ``n`` leaves whose step-1 directions differ most, as (name, gap)."""
    return sorted(ref["first_dir"].items(), key=lambda kv: -kv[1])[:n]


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(harness.benchmark(), args.workload)
    dev = torch.device("cuda")
    sink = open(args.out, "a") if args.out else None
    kinds: dict[str, list] = {"program": [], "control": [], "fault": []}

    limits = spec["cell"]["limits"]

    def record(kind, seed, values, extra=None):
        correct, _ = check.judge(values, limits)
        kinds[kind].append((values, correct))
        row = {"workload": args.workload, "kind": kind, "seed": seed, "correct": correct, "numbers": values,
               "limits": limits, **(extra or {})}
        print(json.dumps(row), flush=True)
        if sink:
            sink.write(json.dumps(row) + "\n")
            sink.flush()

    quiet = lambda *a: None  # noqa: E731

    for j in range(max(args.seeds, args.control, args.fault_seeds if args.fault else 0)):
        seed = args.first_seed + j
        if j < args.seeds:
            t = time.perf_counter()
            out = train.run(spec, seed, 1.0, False, "cuda", time.time(), log=quiet)
            prog, ref = out["readings"]["program"], out["readings"]["reference"]
            record("program", seed, out["values"],
                   {"seconds": time.perf_counter() - t, "setup_s": out["setup_s"], "loss": prog["loss"],
                    "ref_loss": ref["loss"], "grad_norm": prog["grad_norm"], "ref_grad_norm": ref["grad_norm"],
                    "worst": {k: check.worst_leaves(prog, ref, k) for k in ("first_grad", "change")},
                    "worst_dir": worst_dir(ref)})
        if j < args.control:
            t = time.perf_counter()
            ctrl, ref = control(spec, seed, dev)
            record("control", seed, check.numbers(ctrl, ref),
                   {"seconds": time.perf_counter() - t, "loss": ctrl["loss"], "ref_loss": ref["loss"],
                    "grad_norm": ctrl["grad_norm"], "ref_grad_norm": ref["grad_norm"], "worst_dir": worst_dir(ref)})
        if args.fault and j < args.fault_seeds:
            from repro_torch.training import train_step as ts

            orig, faulty = half_batch(ts)
            ts.accumulate_grads = faulty
            try:
                out = train.run(spec, seed, 1.0, False, "cuda", time.time(), log=quiet)
            finally:
                ts.accumulate_grads = orig
            record("fault", seed, out["values"], {"loss": out["readings"]["program"]["loss"],
                                                  "ref_loss": out["readings"]["reference"]["loss"]})
    for kind, rows in kinds.items():
        if rows:
            summary = {n: {"min": min(r[n] for r, _ in rows), "max": max(r[n] for r, _ in rows)}
                       for n in check.NUMBERS}
            print(json.dumps({"workload": args.workload, "summary": kind, "n": len(rows),
                              "correct": sum(c for _, c in rows), **summary}), flush=True)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
