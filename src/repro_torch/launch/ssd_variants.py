"""Where the time of the bf16 SSD kernels goes: ``csrc/ssd_scan.cu`` built
as it is and with one part taken out, each variant timed at mamba2-1.3b's
serving shape on the card.

    PYTHONPATH=src python -m repro_torch.launch.ssd_variants

Each variant is the source with a few lines replaced, built by ``nvcc`` into
``build/ssd_variants/`` (one ``nvcc`` per variant, all started together) and
loaded with ctypes beside the port's own library. A variant that takes a
part out computes wrong numbers: only its time means something. The
variants:

- ``as built``: the source as it is;
- ``no loads``: ``cp.async`` copies nothing (the tiles keep whatever shared
  memory holds), so the kernels' arithmetic alone is left;
- ``no products``: the loops of ``mma.sync`` run no step, so the loads, the
  cumsum and the writes are left;
- ``one term``: each fp32 operand enters the products as one bf16 term
  instead of three;
- ``no exponentials``: ``ssd_states`` scales the scores by cum_i − cum_j
  instead of its exponential.

Prints, per variant and in two rounds, device ms per call of ``ssd_states``
and ``ssd_output`` (a CUDA graph of 50 calls, replayed 5 times) and, for
``as built``, max |Δ| / tolerance against the plain versions. Needs a CUDA
card.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ssd_scan import inter_chunk_scan

SHAPE = (1, 1024, 64, 64, 128, 256)  # b, t, h, p, n, chunk: mamba2-1.3b, prompt 1024
VARIANTS = {
    "as built": [],
    "no loads": [('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(s), "l"(gmem), '
                  '"r"(src_bytes));', "  (void)s;")],
    "no products": [("    for (int kc = 0; kc < NP / 16; ++kc) {", "    for (int kc = 0; kc < 0; ++kc) {"),
                    ("    for (int kk = 0; kk < BCM / 16; ++kk) {", "    for (int kk = 0; kk < 0; ++kk) {"),
                    ("    for (int kc = 0; kc < OKM / 16; ++kc) {", "    for (int kc = 0; kc < 0; ++kc) {")],
    "one term": [("  mma_16816(c, lo, b0, b1);\n  mma_16816(c, mid, b0, b1);\n", ""),
                 ("for (int term = 2; term >= 0; --term)", "for (int term = 0; term >= 0; --term)")],
    "no exponentials": [("expf(cum_i[0] - cl), ri1 = expf(cum_i[1] - cl);", "(cum_i[0] - cl), ri1 = (cum_i[1] - cl);"),
                        ("v * expf(cum_i[hr] - cum[j])", "v * (cum_i[hr] - cum[j])")],
}
OUT = _build.BUILD_DIR / "ssd_variants"


def build() -> dict[str, ctypes.CDLL]:
    src = (_build.CSRC / _build.SOURCES["ssd_scan"]).read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) < 1:
                raise RuntimeError(f"variant {name!r}: {old[:60]!r} is not in the source")
            text = text.replace(old, new)
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_variants times kernels on a CUDA card")
    b, t, h, p, n, cs = SHAPE
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(b, t, h, p)).astype(np.float32)).to("cuda", torch.bfloat16)
    dA = -torch.from_numpy(np.abs(rng.normal(size=(b, t, h))).astype(np.float32)).cuda() * 0.3
    B_, C_ = (torch.from_numpy(rng.normal(size=(b, t, 1, n)).astype(np.float32)).to("cuda", torch.bfloat16)
              for _ in range(2))
    yd_ref, S_ref = ref.ssd_states_reference(x, dA, B_, C_, cs)
    H_in, _ = inter_chunk_scan(S_ref, dA, cs)
    y_ref = ref.ssd_output_reference(yd_ref, dA, C_, H_in, torch.bfloat16)
    nc = -(-t // cs)
    libs = build()
    print(torch.cuda.get_device_name(0))
    for rnd in range(2):
        for name, lib in libs.items():
            states, output = lib.ssd_states_fwd, lib.ssd_output_fwd
            states.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 10 + [
                ctypes.c_int, ctypes.c_void_p]
            output.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8 + [
                ctypes.c_int, ctypes.c_void_p]
            yd = torch.empty((b, nc, h, cs, p), dtype=torch.float32, device="cuda")
            S = torch.empty((b, nc, h, p, n), dtype=torch.float32, device="cuda")
            y = torch.empty((b, t, h, p), dtype=torch.bfloat16, device="cuda")

            def run_states():
                states(x.data_ptr(), dA.data_ptr(), B_.data_ptr(), C_.data_ptr(), yd.data_ptr(), S.data_ptr(),
                       b, t, h, p, n, cs, *x.stride()[:3], *dA.stride(), *B_.stride()[:2], *C_.stride()[:2], 1,
                       torch.cuda.current_stream().cuda_stream)

            def run_output():
                output(yd_ref.data_ptr(), dA.data_ptr(), C_.data_ptr(), H_in.data_ptr(), y.data_ptr(),
                       b, t, h, p, n, cs, *dA.stride(), *C_.stride()[:2], *y.stride()[:3], 1,
                       torch.cuda.current_stream().cuda_stream)

            line = f"round {rnd} {name:16s} ssd_states {graph_ms(run_states):.4f} ms, ssd_output {graph_ms(run_output):.4f} ms"
            if name == "as built":
                run_states()
                run_output()
                torch.cuda.synchronize()
                spreads = [float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())
                           for got, want, (atol, rtol) in ((yd, yd_ref, (5e-4, 1e-3)), (S, S_ref, (5e-4, 1e-3)),
                                                           (y, y_ref, (2e-2, 1e-2)))]
                line += "; max|d|/tol y_diag %.3g, S %.3g, y %.3g" % tuple(spreads)
            print(line, flush=True)


if __name__ == "__main__":
    main()
