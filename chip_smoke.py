#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits non-zero:

1. device: the card's name, count, and power limit;
2. build: both CUDA kernels from src/repro_torch/csrc with nvcc for sm_90a;
3. each kernel against its plain PyTorch version on the card, over the
   tests/test_kernels.py grids in fp32 and bf16 and at the serving shapes of
   qwen3-4b, with times of kernel, plain version and the PyTorch library call
   (a yardstick only: the port never calls it) beside the bound;
4. model parity: qwen3-4b at full width, cut to 2 layers, fp32; one set of
   seeded weights; a teacher-forced 64-token prefill and 4 decode steps on the
   card (kernels) and on the CPU (plain path), logits compared;
5. serving: ``repro_torch.launch.serve`` with qwen3-4b at full width and
   depth, bf16, 8 requests, prompt 128, 32 new tokens, max batch 4; kernel
   launch counts checked against the number of prefill and decode calls;
6. a ``kernels:`` summary line (launches and max|Δ| per kernel), the JSON
   line ``{"kernels": [...]}`` with every measured number, then the result
   line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, decode_attention, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash_module  # noqa: E402
from repro_torch.kernels.decode_attention import paged_decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# FLOP/s, fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLASH_GRID = [  # tests/test_kernels.py
    (2, 256, 8, 4, 64, True, None),
    (1, 384, 4, 1, 128, True, None),
    (2, 256, 8, 8, 64, False, None),
    (1, 512, 4, 2, 64, True, 128),
    (1, 200, 4, 2, 64, True, None),
    (1, 256, 2, 2, 32, True, None),
]
PAGED_GRID = [(2, 8, 4, 64, 16, 128, 4), (4, 4, 1, 128, 32, 128, 6), (2, 16, 8, 64, 16, 256, 3)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py::_tol, rtol 1e-2
PARITY_ATOL = 5e-3  # phase 4, see there
KERNELS = {
    "flash_attention": dict(route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:152"),
    "paged_decode": dict(route="cuda", source="src/repro_torch/csrc/paged_decode.cu",
                         replaces="src/repro/kernels/decode_attention.py:111"),
}


def randn(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)


def check(name, out, expect, dtype) -> float:
    """max|Δ| of kernel output against its plain version; raises past tolerance."""
    torch.cuda.synchronize()
    diff = (out.float() - expect.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    ok = bool((diff <= TOL[dtype] + 1e-2 * expect.float().abs()).all())
    print(f"  {name}: max|d|={err:.3e} tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max|d|={err})")
    return err


def _events_ms(run, n) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def eager_ms(fn, iters=200) -> float:
    """Time per call of back-to-back eager calls: the larger of the host's
    launch cost and the device time."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn() for _ in range(iters)], iters)


def device_ms(fn, iters=100, reps=5) -> float:
    """Device time per call: ``iters`` calls captured in a CUDA graph and
    replayed, so no host launch cost is in the figure (inputs L2-warm)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(lambda: [graph.replay() for _ in range(reps)], iters * reps)


def timings(kernel, plain, library) -> dict:
    t = dict(ms=device_ms(kernel), plain_ms=device_ms(plain), library_ms=device_ms(library),
             eager_ms=eager_ms(kernel), plain_eager_ms=eager_ms(plain, 50), library_eager_ms=eager_ms(library))
    print("  " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    return t


def bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[1 device] {name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s wall, nvcc {' '.join(_build.NVCC_FLAGS)}")
    for rep in reports.values():
        print(f"  {rep.name}: {rep.seconds:.1f} s -> {rep.path.name}")
        for line in rep.resources():
            print(f"    {line}")
    hds = (16, 32, 64, 128)
    print("  dynamic shared memory per block: flash_attention "
          + ", ".join(f"hd {hd}: {flash_module.shared_memory_bytes(hd)} B" for hd in hds)
          + "; paged_decode at G=4 "
          + ", ".join(f"hd {hd}: {decode_attention.shared_memory_bytes(hd, 4)} B" for hd in hds))


def phase_kernels() -> dict:
    print("[3 kernels vs plain versions]")
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, H, K, hd, causal, window in FLASH_GRID:
            q = randn(rng, (B, T, H, hd), dtype)
            k, v = randn(rng, (B, T, K, hd), dtype), randn(rng, (B, T, K, hd), dtype)
            check(f"flash {B},{T},{H},{K},{hd} causal={causal} window={window} {dtype}",
                  flash_attention(q, k, v, causal=causal, window=window),
                  ref.mha_reference(q, k, v, causal=causal, window=window), dtype)
        for B, H, K, hd, P, page, maxp in PAGED_GRID:
            q = randn(rng, (B, H, hd), dtype)
            pk, pv = randn(rng, (P, page, K, hd), dtype), randn(rng, (P, page, K, hd), dtype)
            pt = torch.from_numpy(rng.integers(0, P, size=(B, maxp)).astype(np.int32)).cuda()
            lens = torch.from_numpy(rng.integers(1, maxp * page, size=(B,)).astype(np.int32)).cuda()
            check(f"paged {B},{H},{K},{hd},{P},{page},{maxp} {dtype}",
                  paged_decode_attention(q, pk, pv, pt, lens),
                  ref.paged_decode_reference(q, pk, pv, pt, lens), dtype)

    dt, es = torch.bfloat16, 2
    results = {}
    # prefill at the serving shapes: B=1, T=128, H=32, K=8, hd=128, causal
    B, T, H, K, hd = 1, 128, 32, 8, 128
    q = randn(rng, (B, T, H, hd), dt)
    k, v = randn(rng, (B, T, K, hd), dt), randn(rng, (B, T, K, hd), dt)
    err = check("flash serving shape", flash_attention(q, k, v), ref.mha_reference(q, k, v), dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
    flops = 4 * hd * H * B * T * (T + 1) // 2
    bound_ms, by = bound(nbytes, flops, dt)
    print(f"  flash serving shape, ms per call (sdpa = library yardstick), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t = timings(lambda: flash_attention(q, k, v), lambda: ref.mha_reference(q, k, v),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
    results["flash_attention"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)

    # decode at the serving shapes: B=1, H=32, K=8, hd=128, page 64, a 256-slot cache
    H, K, hd, page, S = 32, 8, 128, 64, 256
    kc, vc = randn(rng, (1, S, K, hd), dt), randn(rng, (1, S, K, hd), dt)
    pk, pv = kc.view(S // page, page, K, hd), vc.view(S // page, page, K, hd)
    pt = torch.arange(S // page, dtype=torch.int32, device="cuda").view(1, -1)
    q = randn(rng, (1, H, hd), dt)
    err = 0.0
    for length in range(0, S + 1):
        lens = torch.tensor([length], dtype=torch.int32, device="cuda")
        out, expect = paged_decode_attention(q, pk, pv, pt, lens), ref.paged_decode_reference(q, pk, pv, pt, lens)
        torch.cuda.synchronize()
        d = (out.float() - expect.float()).abs()
        if not bool((d <= TOL[dt] + 1e-2 * expect.float().abs()).all()):
            raise AssertionError(f"paged decode disagrees at length {length}: max|d|={d.max().item()}")
        err = max(err, d.max().item())
    print(f"  paged serving shape, lengths 0..{S}: max|d|={err:.3e} tol={TOL[dt]:.0e} ok")
    L = 160
    lens = torch.tensor([L], dtype=torch.int32, device="cuda")
    qs, ks, vs = q.view(1, H, 1, hd), kc[:, :L].transpose(1, 2), vc[:, :L].transpose(1, 2)
    nbytes = 2 * L * K * hd * es + 2 * q.numel() * es + pt.numel() * 4 + 4
    flops = 4 * H * hd * L
    bound_ms, by = bound(nbytes, flops, dt)
    print(f"  paged serving shape at length {L}, ms per call (sdpa = library yardstick), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t = timings(lambda: paged_decode_attention(q, pk, pv, pt, lens),
                lambda: ref.paged_decode_reference(q, pk, pv, pt, lens),
                lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True))
    results["paged_decode"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)
    return results


def phase_parity() -> None:
    """Teacher-forced logits, card (kernels) against CPU (plain path), fp32.

    Tolerance PARITY_ATOL on logits of magnitude ~4: both sides compute in
    fp32 (TF32 off) and differ only in summation order (~1e-5), except that
    the KV cache is bf16 on both; a last-ulp fp32 difference can round a
    cached element to the neighbouring bf16 value (2^-8 relative), which moves
    a score, and so a logit, by far less than 1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=2, dtype="float32")
    t0 = time.perf_counter()
    cpu = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, 64))).long()
    feed = torch.from_numpy(rng.integers(0, cfg.vocab, size=(4, 1, 1))).long()
    errs, agree = [], []
    with torch.no_grad():
        lc, cc = cpu.prefill(prompt, pad_to=256)
        lg, cg = gpu.prefill(prompt.cuda(), pad_to=256)
        steps = [(lc, lg)]
        for i in range(4):
            lc, cc = cpu.decode_step(cc, feed[i])
            lg, cg = gpu.decode_step(cg, feed[i].cuda())
            steps.append((lc, lg))
    for lc, lg in steps:
        lg = lg.cpu()
        if not torch.isfinite(lg).all() or lg.shape != (1, cfg.padded_vocab):
            raise AssertionError(f"bad logits: shape {tuple(lg.shape)}")
        errs.append((lc - lg)[:, : cfg.vocab].abs().max().item())
        agree.append(int(lc.argmax()) == int(lg.argmax()))
    print(f"[4 model parity] qwen3-4b full width, 2 layers, fp32, prefill 64 + 4 decode: "
          f"max|d| per step {['%.2e' % e for e in errs]} tol={PARITY_ATOL:.0e}, "
          f"argmax agree {agree}, {time.perf_counter() - t0:.1f} s")
    if max(errs) > PARITY_ATOL:
        raise AssertionError(f"card and CPU logits differ by {max(errs)}")
    del cpu, gpu, cc, cg
    torch.cuda.empty_cache()


def phase_serve() -> dict:
    cfg = get_config("qwen3-4b")
    n_req, prompt_len, max_new = 8, 128, 32
    torch.cuda.reset_peak_memory_stats()
    model = serve.build(cfg, "cuda")
    flash_attention.launches = 0
    paged_decode_attention.launches = 0
    engine, m = serve.run(model, requests=n_req, prompt_len=prompt_len, max_new=max_new, max_batch=4)
    launches = {"flash_attention": flash_attention.launches, "paged_decode": paged_decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"[5 serve] qwen3-4b {cfg.n_layers} layers d_model {cfg.d_model} bf16: requests {m['requests']}, "
          f"tokens {m['tokens']}, {m['tokens_per_s']:.2f} tok/s over {m['wall_s']:.3f} s, "
          f"mean TTFT {m['mean_ttft_s'] * 1e3:.2f} ms, mean latency {m['mean_latency_s'] * 1e3:.2f} ms, "
          f"peak memory {peak / 2**30:.3f} GiB, prefill calls {m['prefill_calls']}, "
          f"decode calls {m['decode_calls']}, launches {launches}")
    if m["requests"] != n_req or any(len(r.tokens) != max_new for r in engine.finished):
        raise AssertionError("not every request got its tokens")
    if not all(0 <= t < cfg.vocab for r in engine.finished for t in r.tokens):
        raise AssertionError("a token id outside the vocabulary")
    if launches["flash_attention"] != cfg.n_layers * m["prefill_calls"] or m["prefill_calls"] != n_req:
        raise AssertionError(f"flash launches {launches['flash_attention']} != layers x requests")
    if launches["paged_decode"] != cfg.n_layers * m["decode_calls"] or m["decode_calls"] == 0:
        raise AssertionError(f"paged-decode launches {launches['paged_decode']} != layers x decode calls")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a card", file=sys.stderr)
        return 1
    name = phase_device()
    phase_build()
    results = phase_kernels()
    phase_parity()
    launches = phase_serve()
    print("kernels: " + json.dumps({k: {"launches": launches[k], "max_abs_err": results[k]["max_abs_err"]}
                                    for k in KERNELS}))
    line = {"kernels": [{"name": k, **KERNELS[k], "launches": launches[k], **results[k]} for k in KERNELS]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
