"""The model families that the training mode runs, one module each, found by
the name that a configuration's ``model`` block gives (``model.family``,
the port's ``ModelConfig.family``): ``portbench/families/<family>.py``.

A family module holds what differs between families, and the training mode
(``portbench/modes/train.py``), the weights (``portbench/weights.py``) and
the reference's steps (``portbench/reference/train.py``) take it from there:

- ``FIELDS``: the keys of the ``model`` block that the port's config must
  hold alike (``ATTRS`` maps a key to another attribute of the config), and
  ``FIXED``: config attributes that the family fixes;
- ``leaf_specs(m)``: ``[(name, shape, weights.Init)]``, the parameters in
  draw order;
- ``reference``: the plain reference's module, whose ``loss(p, tokens,
  labels, m, precision)`` the reference's steps take;
- ``flops_per_token(m, T)``: a training token's model FLOPs;
- ``targets()``: ``{range: (owner, attribute[, shape])}``, the program's
  calls that a traced run wraps in the benchmark's ranges
  (``portbench.timeline.patched``); with ``shape``, each call's
  ``shape(*args, **kwargs)`` is recorded in the profiled steps.

A module imports nothing of the program at its top: ``targets`` imports it
when a traced run calls it.
"""
from __future__ import annotations

import importlib
import re

NAME = re.compile(r"^[a-z][a-z0-9_]{0,31}$")


def of(m: dict):
    """The family module of the configuration's ``model`` block ``m``."""
    name = m["family"]
    if not NAME.match(name):
        raise ValueError(f"no model family named {name!r}")
    module = f"portbench.families.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no model family named {name!r} (looked for portbench/families/{name}.py)") from e
