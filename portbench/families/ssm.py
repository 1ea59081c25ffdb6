"""The Mamba-2 family (``model.family`` "ssm": mamba2-1.3b): attention-free
pre-norm blocks of the SSD mixer (arXiv:2405.21060). The reference is
:mod:`portbench.reference.mamba2`."""
from __future__ import annotations

import math

import torch

from portbench import flops
from portbench.reference import mamba2 as reference  # noqa: F401 (read as families.of(m).reference)
from portbench.weights import ZEROS, Init, constant, normal, padded_vocab

FIELDS = ("n_layers", "d_model", "vocab", "vocab_pad_multiple", "ssm_state", "ssm_head_dim", "ssm_expand",
          "ssm_chunk", "conv_kernel", "ssm_groups", "tie_embeddings", "rms_eps", "dtype")
ATTRS: dict = {}
FIXED = {"family": "ssm", "norm_type": "rmsnorm", "use_rope": False, "pos_emb": "none"}

A_INIT_RANGE = (1.0, 16.0)  # mamba_ssm's Mamba2: A drawn in [1, 16], here evenly spread as the port's init
DT_MIN, DT_MAX, DT_FLOOR = 0.001, 0.1, 1e-4  # mamba_ssm's Mamba2: dt_min, dt_max, dt_init_floor


def _a_log(t: torch.Tensor, g) -> torch.Tensor:
    """log(linspace(1, 16, heads)) in every layer."""
    return t.copy_(torch.log(torch.linspace(*A_INIT_RANGE, t.shape[-1], device=t.device)))


def _dt_bias(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """The inverse softplus of a dt drawn log-uniform in [0.001, 0.1] and
    floored at 1e-4, as mamba_ssm's ``Mamba2`` initialises it."""
    t.uniform_(0.0, 1.0, generator=g)
    dt = t.mul_(math.log(DT_MAX) - math.log(DT_MIN)).add_(math.log(DT_MIN)).exp_().clamp_(min=DT_FLOOR)
    return dt.add_(torch.log(-torch.expm1(-dt)))


def leaf_specs(m: dict) -> list:
    """Mamba-2's parameters, the port's names and shapes: matrices and the
    conv's taps a normal of std fan_in^-½, norm scales and the conv's bias
    zero, ``A_log``, ``dt_bias`` and ``D`` their published initial values."""
    d, L, V, k = m["d_model"], m["n_layers"], padded_vocab(m), m["conv_kernel"]
    d_in, nh, proj = flops.mamba2_dims(m)
    conv_dim = d_in + 2 * m["ssm_groups"] * m["ssm_state"]
    specs = [("embed", (V, d), normal(d**-0.5)), ("ln", (L, d), ZEROS), ("ln_f", (d,), ZEROS),
             ("in_proj", (L, d, proj), normal(d**-0.5)), ("conv_w", (L, conv_dim, k), normal(k**-0.5)),
             ("conv_b", (L, conv_dim), ZEROS), ("A_log", (L, nh), Init(_a_log, False)),
             ("dt_bias", (L, nh), Init(_dt_bias, True)), ("D", (L, nh), constant(1.0)), ("norm", (L, d_in), ZEROS),
             ("out_proj", (L, d_in, d), normal(d_in**-0.5))]
    if not m["tie_embeddings"]:
        specs.append(("out_embed", (V, d), normal(d**-0.5)))
    return specs


def flops_per_token(m: dict, T: int) -> float:
    return flops.mamba2_train_flops_per_token(m, T)


def ssd_shape(x, dA, B_, C_, chunk) -> tuple:
    """An SSD call's arguments to ``portbench.flops.ssd_scan_bound_s``."""
    b, t, h, p = x.shape
    return (b, t, h, p, B_.shape[2], B_.shape[3], chunk, x.element_size())


def targets() -> dict:
    """The SSD's backward in torch ops (``ops.ssd_backward``, as
    ``ops.SSDScan`` calls it) and its forward's calls (``ops.ssd_scan``: the
    two kernels and the recurrence between them) with their shapes."""
    from repro_torch.kernels import ops

    return {"ssd_backward": (ops, "ssd_backward"), "ssd_scan": (ops, "ssd_scan", ssd_shape)}
