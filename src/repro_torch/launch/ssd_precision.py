"""How far a bf16 rounding inside the SSD kernels would move their outputs,
measured on the CPU in multiples of the tolerance each output is held to.

    PYTHONPATH=src python -m repro_torch.launch.ssd_precision [--serving]

A tensor-core kernel multiplies bf16 operands. The JAX model rounds three
fp32 values to bf16 before it multiplies them: the scores C·Bᵀ ⊙ L
(``src/repro/models/mamba2.py:75``), ``decay_states`` (:79, here the
operand x ⊙ decay) and the carried state H (:84-88). Two implementations that
sum or exponentiate in another order give fp32 values that differ in the last
bits, and now and then those round to neighbouring bf16 values. Each row
computes ssd_states' outputs twice, with one such detail changed, and prints
max |a − b| / (atol + rtol·|a|) over the elements (above 1: outside the
tolerance):

- ``C·Bᵀ f64``: C·Bᵀ summed in float64 instead of float32;
- ``decays f64``: exp(cum_i − cum_j) and exp(cum[-1] − cum_j) from float64;
- ``scan order``: the cumsum of dA added up in the kernels' order (pairs,
  then a 32-lane shuffle scan, then the warps' totals) instead of in turn.

y_diag and S are held to the fp32 tolerance (5e-4, 1e-3), with the operand
rounded to bf16 (as the JAX model), taken as three bf16 terms (as the
kernels: :func:`repro_torch.kernels.ref.bf16x3`, exact) and in fp32. Last,
y of the chunked path (the plain versions around the inter-chunk scan)
against the sequential oracle at the bf16 tolerance (2e-2, 1e-2), with H_in
rounded to bf16 before C·H_inᵀ and without, and y of the model's CPU path
(``models.mamba2.ssd_chunked``, which rounds at the JAX model's four
points). Inputs are bf16, made from a seed with numpy, as in
tests/test_torch_gpu.py.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import inter_chunk_scan
from repro_torch.models import mamba2

F32_TOL = (5e-4, 1e-3)
BF16_TOL = (2e-2, 1e-2)
# (b, t, h, p, n, chunk): tests/test_torch_gpu.py's SSD_GRID without the serving shape
GRID = [(1, 128, 4, 32, 64, 32), (2, 256, 2, 64, 128, 64), (1, 64, 8, 16, 32, 64),
        (1, 300, 2, 64, 128, 100), (2, 70, 3, 16, 16, 32), (1, 200, 2, 128, 256, 256)]
SERVING = (1, 1024, 64, 64, 128, 256)  # mamba2-1.3b, prompt 1024
OPERANDS = ("bf16", "bf16x3", "fp32")


def inputs(b, t, h, p, n, seed=0):
    """bf16 x, B_, C_ and fp32 dA, as tests/test_torch_gpu.py::_ssd_inputs."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, t, h, p)).astype(np.float32)).bfloat16()
    dA = -torch.from_numpy(np.abs(rng.normal(size=(b, t, h))).astype(np.float32)) * 0.3
    B_, C_ = (torch.from_numpy(rng.normal(size=(b, t, 1, n)).astype(np.float32)).bfloat16() for _ in range(2))
    return x, dA, B_, C_


def _product(eq, a, b, operand):
    """einsum(eq, a, b) with ``a`` taken as ``operand``: rounded to bf16,
    as three bf16 terms (one product each), or fp32."""
    if operand == "bf16":
        return torch.einsum(eq, a.bfloat16().float(), b)
    if operand == "bf16x3":
        return sum(torch.einsum(eq, term, b) for term in ref.bf16x3(a))
    return torch.einsum(eq, a, b)


def scan_order_cumsum(a: torch.Tensor) -> torch.Tensor:
    """cumsum over dim 2 of a (b,nc,cs,h) in the order of the kernels'
    ``chunk_cumsum_mma``: thread k adds positions 2k and 2k + 1, a warp of 32
    threads scans those pairs by shuffles (Hillis-Steele), and each warp adds
    the totals of the warps before it in turn."""
    b, nc, cs, h = a.shape
    a = torch.nn.functional.pad(a, (0, 0, 0, 256 - cs))
    a0, a1 = a[:, :, 0::2], a[:, :, 1::2]  # (b,nc,128,h)
    v = (a0 + a1).reshape(b, nc, 4, 32, h)
    for o in (1, 2, 4, 8, 16):
        v = v + torch.nn.functional.pad(v, (0, 0, o, 0))[:, :, :, :32]
    excl = torch.nn.functional.pad(v, (0, 0, 1, 0))[:, :, :, :32]
    offset = torch.zeros_like(v[:, :, 0, :1])
    for w in range(4):
        excl[:, :, w] = excl[:, :, w] + offset
        offset = offset + v[:, :, w, 31:]
    excl = excl.reshape(b, nc, 128, h)
    even = excl + a0
    return torch.stack([even, even + a1], dim=3).reshape(b, nc, 256, h)[:, :, :cs]


def states(x, dA, B_, C_, chunk, operand, cb_f64=False, decays_f64=False, scan_order=False):
    """ssd_states' y_diag and S (as ref.ssd_states_reference) with the
    scores and x ⊙ decay taken as ``operand``."""
    xc = ref._chunked(x, chunk)
    a = ref._chunked(dA, chunk)
    cum = scan_order_cumsum(a) if scan_order else torch.cumsum(a, dim=2)
    Bc, Cc = ref._chunked(B_[:, :, 0], chunk), ref._chunked(C_[:, :, 0], chunk)
    c = cum.double() if decays_f64 else cum
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    L = torch.exp(torch.where(causal[:, :, None], c[:, :, :, None] - c[:, :, None], ref.NEG_INF)).float()
    decay = torch.exp(c[:, :, -1:] - c).float()
    if cb_f64:
        CB = torch.einsum("bcin,bcjn->bcij", Cc.double(), Bc.double()).float()
    else:
        CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = _product("bcijh,bcjhp->bchip", CB[..., None] * L, xc, operand)
    S = _product("bcjhp,bcjn->bchpn", xc * decay[..., None], Bc, operand)
    return y_diag, S


def spread(expect, got, tol) -> float:
    """max |expect − got| / (atol + rtol·|expect|)."""
    atol, rtol = tol
    expect, got = expect.float(), got.float()
    return float(((expect - got).abs() / (atol + rtol * expect.abs())).max())


def chunked_y(x, dA, B_, C_, chunk, round_h: bool):
    """y of the plain versions around the inter-chunk scan, H_in rounded to
    bf16 before C·H_inᵀ or not."""
    y_diag, S = ref.ssd_states_reference(x, dA, B_, C_, chunk)
    H_in, _ = inter_chunk_scan(S, dA, chunk)
    if round_h:
        H_in = H_in.bfloat16().float()
    return ref.ssd_output_reference(y_diag, dA, C_, H_in, x.dtype)


def measure(shape) -> dict:
    *dims, chunk = shape
    x, dA, B_, C_ = inputs(*dims)
    out = {}
    for operand in OPERANDS:
        y0, S0 = states(x, dA, B_, C_, chunk, operand)
        y1, _ = states(x, dA, B_, C_, chunk, operand, cb_f64=True)
        y2, S2 = states(x, dA, B_, C_, chunk, operand, decays_f64=True)
        y3, S3 = states(x, dA, B_, C_, chunk, operand, scan_order=True)
        out[operand] = dict(cb_y=spread(y0, y1, F32_TOL), decay_y=spread(y0, y2, F32_TOL),
                            decay_S=spread(S0, S2, F32_TOL), scan_y=spread(y0, y3, F32_TOL),
                            scan_S=spread(S0, S3, F32_TOL))
    oracle, _ = ref.ssd_chunk_reference(x, dA, B_, C_)
    out["y_vs_oracle"] = {name: spread(oracle, chunked_y(x, dA, B_, C_, chunk, round_h), BF16_TOL)
                          for name, round_h in (("H bf16", True), ("H fp32", False))}
    out["y_vs_oracle"]["the model's rounding"] = spread(oracle, mamba2.ssd_chunked(x, dA, B_, C_, chunk)[0], BF16_TOL)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serving", action="store_true", help="also mamba2-1.3b's serving shape (about a minute)")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    keys = ("cb_y", "decay_y", "decay_S", "scan_y", "scan_S")
    print("shape (b,t,h,p,n,chunk) | operand: y_diag C·Bᵀ f64, y_diag decays f64, S decays f64, "
          "y_diag scan order, S scan order (fp32 tol) | y vs oracle (bf16 tol)")
    for shape in GRID + ([SERVING] if args.serving else []):
        m = measure(shape)
        cols = "; ".join(f"{op}: " + ", ".join(f"{m[op][k]:.3g}" for k in keys) for op in OPERANDS)
        oracle = ", ".join(f"{k}: {v:.3g}" for k, v in m["y_vs_oracle"].items())
        print(f"{shape} | {cols} | {oracle}", flush=True)


if __name__ == "__main__":
    main()
