"""The comparison that decides ``correct`` for a training cell.

The program's first steps (the set-up's, through the window's own call and
feed) and the reference's (:func:`portbench.reference.train.follow`) give
the same readings; these numbers compare them:

- ``loss``: the widest gap of a step's loss, over the reference's;
- ``loss_first``: the same of step 1's loss alone, which no update has
  touched: AdamW's first update is the sign of each gradient element, so
  rounding-level gaps become whole steps of the rate and the later steps'
  losses drift apart on their own (qwen2-moe, PERF.md);
- ``grad_norm``: the widest gap of a step's global gradient norm before
  clipping, over the reference's; ``grad_norm_first`` the same of step 1's;
- ``first_grad``: the worst leaf's gap between the norms of step 1's
  clipped gradient (the program's worked out from its AdamW state after one
  step, m / (1 − b1)), over the larger of the reference's norm of that leaf
  and of the median leaf;
- ``change``: the same of the norm of each leaf's change after the last
  checked step, over the leaves whose first gradient in the reference is
  at least a thousandth of the median leaf's (a key bias's is zero to
  rounding under softmax, and Adam moves such a leaf by its round-off).
- ``grad_dir``: the median leaf's 1 − cos of the angle between the
  program's step-1 gradient and the reference's, over the same leaves, and
  ``grad_dir_worst`` the worst leaf's: where a norm averages the rounding of
  each element away, a direction keeps it, so lower products and gradients
  (the control's) show here far above the served precision's.

A number passes where it is at most its limit (the cell's
``portbench/workloads/<cell>.json``); the run is correct where every number
with a limit passes.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss", "loss_first", "grad_norm", "grad_norm_first", "first_grad", "change", "grad_dir",
           "grad_dir_worst")
MOVES_FLOOR = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's takes no part in `change`


def _step_gap(prog: list[float], ref: list[float]) -> float:
    if len(prog) != len(ref):
        return math.inf
    return _worst(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def _leaf_gap(prog: dict, ref: dict, names) -> float:
    names = list(names)
    if not names or any(n not in prog for n in names):
        return math.inf
    median = statistics.median(ref[n] for n in names)
    return _worst(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def _of_leaves(gaps: dict | None, names, pick) -> float:
    """``pick`` (the median, or the largest) of the leaves' ``gaps``; inf
    where a leaf's is missing or any is not a finite number."""
    names = list(names)
    if not gaps or not names or any(n not in gaps for n in names):
        return math.inf
    values = [gaps[n] for n in names]
    return pick(values) if all(math.isfinite(v) for v in values) else math.inf


def _worst(gaps) -> float:
    """The largest gap; inf where any is not a finite number (a NaN read)."""
    gaps = list(gaps)
    return max(gaps) if gaps and all(math.isfinite(g) for g in gaps) else math.inf


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers of the program's readings ``prog`` against the
    reference's ``ref`` (each a dict with ``loss``, ``grad_norm``,
    ``first_grad`` and ``change``; ``ref`` with ``first_dir``, its gap of
    direction from the program's step-1 gradient). A reading that is missing
    or not finite gives inf."""
    g_ref = ref["first_grad"]
    g_median = statistics.median(g_ref.values())
    moving = [n for n, g in g_ref.items() if g >= MOVES_FLOOR * g_median]
    out = {
        "loss": _step_gap(prog["loss"], ref["loss"]),
        "loss_first": _step_gap(prog["loss"][:1], ref["loss"][:1]),
        "grad_norm": _step_gap(prog["grad_norm"], ref["grad_norm"]),
        "grad_norm_first": _step_gap(prog["grad_norm"][:1], ref["grad_norm"][:1]),
        "first_grad": _leaf_gap(prog["first_grad"], g_ref, g_ref),
        "change": _leaf_gap(prog["change"], ref["change"], moving),
        "grad_dir": _of_leaves(ref.get("first_dir"), moving, statistics.median),
        "grad_dir_worst": _of_leaves(ref.get("first_dir"), moving, max),
    }
    return out


def judge(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct where every number that
    has a limit is at most it. A cell leaves out the limit of a number that
    neither its control nor a fault separates from sound runs (PERF.md
    gives its readings); that number is not compared."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NUMBERS if n in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def worst_leaves(prog: dict, ref: dict, key: str, n: int = 3) -> list[tuple[str, float, float]]:
    """The ``n`` leaves of reading ``key`` whose program and reference norms
    differ most, as (name, program, reference): for the run's log."""
    r = ref[key]
    return sorted(((k, prog[key].get(k, math.nan), v) for k, v in r.items()),
                  key=lambda t: -abs(t[1] - t[2]) / max(t[2], 1e-30))[:n]
