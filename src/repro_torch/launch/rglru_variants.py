"""Where the time of the RG-LRU scan kernel goes: ``csrc/rglru_scan.cu``
built as it is, with one part taken out or one size changed, and the designs
it is measured against, each timed at recurrentgemma-9b's serving shape
(B 1, T 2048, W 4096, bf16) on the card.

    PYTHONPATH=src python -m repro_torch.launch.rglru_variants
    PYTHONPATH=src python -m repro_torch.launch.rglru_variants --parent build/parent  # and a parent's kernel
    PYTHONPATH=src python -m repro_torch.launch.rglru_variants --mutants  # the checks' reach
    PYTHONPATH=src python -m repro_torch.launch.rglru_variants --precision  # CPU, no card

Each variant is the source with a few lines replaced, built by ``nvcc`` into
``build/rglru_variants/`` (one ``nvcc`` per variant, all started together)
and loaded with ctypes beside the port's own library. The variants:

- ``as built``: the source as it is (tiles of 32 channels by chunks of 128
  steps, 8 sub-chunks of 16, 256 threads);
- ``no loads``: ``cp.async`` copies nothing (the tiles keep whatever shared
  memory holds), so the arithmetic, the look-back and the stores are left;
- ``no wait``: a block does not wait for the flags of the chunks before it
  (the look-back's cost);
- ``L 32`` and ``L 64``: chunks of 2 or 4 sub-chunks of 16 steps (blocks of
  64 or 128 threads, as many threads an SM);
- ``fast exp``: the fast exponential ``__expf`` in place of ``expf``;
- ``two kernels``: the same arithmetic as two launches of the kernel, the
  first publishing every chunk's aggregate and stopping there, the second
  taking tiles in block order and folding with no wait on the flags;
- ``parent`` (with ``--parent DIR``): ``DIR/src/repro_torch/csrc/rglru_scan.cu``
  as it is, a checkout of an earlier commit (``git archive``); before the
  chunked scan that is the one-chunk design, a thread per (b, w) channel
  walking all of T.

``no loads`` and ``no wait`` compute wrong numbers: only their time means
something. Prints, per variant and in two rounds, device ms per call (a
CUDA graph of 50 calls, replayed 5 times) and, for the others, max |Δ| /
tolerance of y and h_last against the plain version. Needs a CUDA card.

``--mutants`` builds the source with its look-back broken in one way each
(``MUTANTS``) and prints max |Δ| / tolerance against the plain version on
the long-memory inputs of ``tests/test_torch_gpu.py`` and on inputs with λ
in [0.5, 4] (the model's initialisation): a mutant within 1 is one those
inputs cannot see. Needs a CUDA card.

``--precision`` prints, on the CPU, max |Δ| / tolerance of
``ref.rglru_chunked_reference`` (the kernel's summation order) against the
sequential ``ref.rglru_reference``, over the chunk sizes and the inputs of
``tests/test_torch_rglru.py``, long memory (a → 1) included.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.rglru_scan import ARGTYPES

SHAPE = (1, 2048, 4096)  # B, T, W: recurrentgemma-9b, prompt 2048
TOL = {torch.float32: (2e-5, 1e-2), torch.bfloat16: (2e-2, 1e-2)}  # tests/test_kernels.py::_tol
# name: (substitutions, computes the function)
VARIANTS = {
    "as built": ([], True),
    "no loads": ([('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(s), '
                   '"l"(gmem), "r"(src_bytes));', "  (void)s;")], False),
    "no wait": ([("while (ld_acquire(flag + k) == 0u) __nanosleep(32);", "(void)flag;")], False),
    "L 32": ([("constexpr int S = 8;", "constexpr int S = 2;"),
              ("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 16;")], True),
    "L 64": ([("constexpr int S = 8;", "constexpr int S = 4;"),
              ("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 8;")], True),
    "fast exp": ([("a[k] = expf(log_a);", "a[k] = __expf(log_a);"),
                  ("sqrtf(fmaxf(1.f - expf(2.f * log_a)", "sqrtf(fmaxf(1.f - __expf(2.f * log_a)")], True),
    # a pass number after Params' last field (0: one launch, as built), the
    # first pass returning once its chunk is published, the second taking
    # tiles in block order, publishing nothing and waiting for no flag
    "two kernels": ([("  float2* agg;", "  float2* agg;\n  int pass;"),
                     ("ticket = atomicAdd(p.ticket, 1u);", "ticket = p.pass == 2 ? blockIdx.x : atomicAdd(p.ticket, 1u);"),
                     ("  if (c + 1 < p.n_chunks && s == 0) {", "  if (p.pass != 2 && c + 1 < p.n_chunks && s == 0) {"),
                     ("  // 4. h entering the chunk.", "  if (p.pass == 1) return;\n  // 4. h entering the chunk."),
                     ("while (ld_acquire(flag + k) == 0u)", "while (p.pass != 2 && ld_acquire(flag + k) == 0u)"),
                     ("  return static_cast<int>(dtype == 0 ? launch<float>(p, st) : launch<__nv_bfloat16>(p, st));",
                      "  p.pass = 1;\n  e = dtype == 0 ? launch<float>(p, st) : launch<__nv_bfloat16>(p, st);\n"
                      "  if (e != cudaSuccess) return static_cast<int>(e);\n  p.pass = 2;\n"
                      "  return static_cast<int>(dtype == 0 ? launch<float>(p, st) : launch<__nv_bfloat16>(p, st));")],
                    True),
}
# the fold of the earlier chunks, broken one way each
MUTANTS = {
    "run 0 skipped": [("  runs_a[s][wl] = run_a;\n  runs_u[s][wl] = run_u;",
                       "  runs_a[s][wl] = s == 0 ? 1.f : run_a;\n  runs_u[s][wl] = s == 0 ? 0.f : run_u;")],
    "runs reversed": [("for (int j = 0; j < S; ++j) h = runs_a[j][wl] * h + runs_u[j][wl];",
                       "for (int j = S - 1; j >= 0; --j) h = runs_a[j][wl] * h + runs_u[j][wl];")],
    "a run reversed": [("for (int k = k0; k < k1; ++k) {", "for (int k = k1 - 1; k >= k0; --k) {")],
    "h0 in chunk 0 only": [("h = p.h0 != nullptr && w < p.W ?", "h = c == 0 && p.h0 != nullptr && w < p.W ?")],
    "far chunks identity": [("const float2 g = __ldcg(agg + k * agg_row);",
                             "const float2 g = k + 1 < c ? make_float2(1.f, 0.f) : __ldcg(agg + k * agg_row);")],
}
# (B, T, W, h0 given, long memory): tests/test_torch_gpu.py's RGLRU_LONG, then with λ in [0.5, 4]
MUTANT_CASES = [(1, 8192, 256, False, True), (3, 1000, 300, True, True), (1, 8192, 256, False, False),
                (3, 200, 300, True, False)]
OUT = _build.BUILD_DIR / "rglru_variants"


def build(variants: dict, parent: Path | None = None) -> dict[str, ctypes.CDLL]:
    """One library per variant of ``variants`` ({name: (substitutions, ...)}),
    and one named ``parent`` built from that checkout's source as it is."""
    src = (_build.CSRC / _build.SOURCES["rglru_scan"]).read_text()
    texts = {}
    for name, (subs, *_) in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old[:60]!r} is not once in the source")
            text = text.replace(old, new)
        texts[name] = text
    if parent is not None:
        texts["parent"] = (parent / "src/repro_torch/csrc" / _build.SOURCES["rglru_scan"]).read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, (name, text) in enumerate(texts.items()):
        cu, so = OUT / f"v{k}.cu", OUT / f"v{k}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib: ctypes.CDLL, x, r, i, lam, h0, y, h):
    """A call of the library's ``rglru_scan_fwd`` on these tensors, with a
    workspace where its signature takes one (a library of before the chunked
    scan takes none)."""
    B, T, W = x.shape
    fn, args = lib.rglru_scan_fwd, [x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
                                    None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr()]
    ws = None
    if hasattr(lib, "rglru_scan_workspace_bytes"):
        lib.rglru_scan_workspace_bytes.argtypes = [ctypes.c_int] * 3
        lib.rglru_scan_workspace_bytes.restype = ctypes.c_longlong
        ws = torch.empty(lib.rglru_scan_workspace_bytes(B, T, W), dtype=torch.uint8, device=x.device)
        fn.argtypes, args = ARGTYPES, args + [ws.data_ptr()]
    else:
        fn.argtypes = ARGTYPES[:7] + ARGTYPES[8:]
    dtype = {torch.float32: 0, torch.bfloat16: 1}[x.dtype]
    args += [B, T, W, *x.stride()[:2], *r.stride()[:2], *i.stride()[:2], dtype]
    return lambda ws=ws: fn(*args, torch.cuda.current_stream().cuda_stream)  # ws lives as long as the call


def graph_ms(fn, iters=50, reps=5) -> float:
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def spread(got, want, tol) -> float:
    """max |Δ| / (atol + rtol·|want|): at most 1 within the tolerance."""
    atol, rtol = tol
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


def inputs(rng, B, T, W, dtype, device, lam_range=(0.5, 4.0), long_memory=False):
    """tests/test_torch_rglru.py's: x normal, r and i uniform, λ uniform, h0 normal."""
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    r = rng.uniform(size=(B, T, W)).astype(np.float32)
    i = rng.uniform(size=(B, T, W)).astype(np.float32)
    lam = rng.uniform(*lam_range, size=(W,)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    if long_memory:  # r near 0 and x > 0: a → 1, and h grows
        x, r = np.abs(x), r * 0.01
    return (*(torch.from_numpy(a).to(device, dtype) for a in (x, r, i)),
            *(torch.from_numpy(a).to(device) for a in (lam, h0)))


def precision() -> None:
    cases = [("λ 0.5–4, T 100", 100, {}, [(1, None, None), (7, None, None), (64, None, None), (100, None, None),
                                           (128, None, None), (64, 16, 4), (7, None, 4), (128, 16, 8)]),
             ("long memory: λ −4–−1, r ≤ 0.01, x > 0, T 1000", 1000, dict(lam_range=(-4.0, -1.0), long_memory=True),
              [(1, None, None), (7, None, None), (7, None, 4), (64, 16, 4), (128, 16, 8), (1024, None, None)])]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, T, kw, chunks in cases:
            x, r, i, lam, h0 = inputs(np.random.default_rng(7), 2, T, 64, dtype, "cpu", **kw)
            y_seq, h_seq = ref.rglru_reference(x, r, i, lam, h0)
            for chunk, sub, runs in chunks:
                y, h = ref.rglru_chunked_reference(x, r, i, lam, h0, chunk, sub, runs)
                sy, sh = spread(y, y_seq, TOL[dtype]), spread(h, h_seq, TOL[torch.float32])
                worst = max(worst, sy, sh)
                print(f"{str(dtype):15s} {label:45s} chunk {chunk:4d} sub {sub or chunk:4d} runs {runs}: "
                      f"max|d|/tol y {sy:.4g}, h_last {sh:.4g} (max|y| {float(y_seq.float().abs().max()):.3g})")
    print(f"worst max|d|/tol {worst:.4g}")


def mutants() -> None:
    libs = build({"as built": ([], True), **{name: (subs, False) for name, subs in MUTANTS.items()}})
    for dt in (torch.float32, torch.bfloat16):
        for B, T, W, given, long_memory in MUTANT_CASES:
            kw = dict(lam_range=(-4.0, -1.0), long_memory=True) if long_memory else {}
            x, r, i, lam, h0 = inputs(np.random.default_rng(12), B, T, W, dt, "cuda", **kw)
            h0 = h0 if given else None
            y_ref, h_ref = ref.rglru_reference(x, r, i, lam, h0)
            line = f"{str(dt):15s} {'long memory' if long_memory else 'λ 0.5–4':11s} {B},{T},{W}{' h0' if given else ''}"
            for name, lib in libs.items():
                y, h = torch.empty_like(x), torch.empty((B, W), dtype=torch.float32, device="cuda")
                if entry(lib, x, r, i, lam, h0, y, h)() != 0:
                    raise RuntimeError(f"mutant {name!r}: the launch failed")
                torch.cuda.synchronize()
                line += f" | {name} {max(spread(y, y_ref, TOL[dt]), spread(h, h_ref, TOL[torch.float32])):.3g}"
            print(line, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", action="store_true", help="the chunked order's precision, on the CPU")
    ap.add_argument("--parent", type=Path, help="a checkout whose kernel is timed beside the variants")
    ap.add_argument("--mutants", action="store_true", help="whether the checks' inputs see a broken look-back")
    args = ap.parse_args()
    if args.precision:
        precision()
        return
    if not torch.cuda.is_available():
        raise SystemExit("rglru_variants times kernels on a CUDA card")
    if args.mutants:
        mutants()
        return
    B, T, W = SHAPE
    dt = torch.bfloat16
    x, r, i, lam, _ = inputs(np.random.default_rng(0), B, T, W, dt, "cuda")
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam)
    libs = build(VARIANTS, args.parent)
    print(torch.cuda.get_device_name(0))
    for rnd in range(2):
        for name, lib in libs.items():
            exact = VARIANTS[name][1] if name in VARIANTS else True
            y = torch.empty((B, T, W), dtype=dt, device="cuda")
            h = torch.empty((B, W), dtype=torch.float32, device="cuda")
            call = entry(lib, x, r, i, lam, None, y, h)
            if call() != 0:
                raise RuntimeError(f"variant {name!r}: the launch failed")
            torch.cuda.synchronize()
            line = f"round {rnd} {name:12s} {graph_ms(call):.4f} ms"
            if exact:
                line += f"; max|d|/tol y {spread(y, y_ref, TOL[dt]):.3g}, h_last {spread(h, h_ref, TOL[torch.float32]):.3g}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
