"""Gradients of a model on the card against the CPU, and what planted faults
in the bf16 flash kernel read there.

    PYTHONPATH=src python -m repro_torch.launch.grad_check            # qwen3-4b, fp32 and bf16 readings
    PYTHONPATH=src python -m repro_torch.launch.grad_check --mutants  # and each planted fault's
    PYTHONPATH=src python -m repro_torch.launch.grad_check --arch granite-moe-1b-a400m
    PYTHONPATH=src python -m repro_torch.launch.grad_check --arch whisper-small
    PYTHONPATH=src python -m repro_torch.launch.grad_check --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.grad_check --arch recurrentgemma-9b --layers 3

``--arch`` (qwen3-4b by default; any config that trains) at full width cut
to ``--layers`` (2 by default; whisper: that many encoder and decoder
layers; recurrentgemma-9b at 3 is one R, R, A group), fp32 masters, compute
in the given dtype, one TokenPipeline batch (B 2, T 512; whisper's with its
1500 frame embeddings). The card runs the flash kernel's forward and
``ops.Attention``'s backward (remat; whisper's encoder and cross-attention
non-causal, cross-attention at T 512 against S 1500), the SSD kernels'
forward and ``ops.SSDScan``'s backward (mamba2), the RG-LRU kernel's forward
and ``ops.RGLRU``'s backward (recurrentgemma), and for a MoE config the MoE
FFN (its dispatch and combine the row-gather kernels of ``ops.MoEDispatch``
and ``ops.MoECombine``, each the other's backward) with the router's
gradient through the gates and the aux loss; the CPU runs the jnp-body ports under autograd (the SSD's chunked
body, the RG-LRU's sequential plain version). Both take one set of weights,
drawn on the card and copied to the CPU. A reading is the loss |Δ| and, per
leaf, the max|Δ| of the gradient over that leaf's max|g| on the CPU.
``chip_smoke.py`` phase 6a gates both at ``GRAD_RTOL`` of the compute dtype,
with every leaf's gradient nonzero on both sides; for mamba2 and
recurrentgemma it gates fp32 and records bf16 (ROADMAP Queue C 11: the CPU
side of bf16 SSD rounds its intermediates to bf16, where the kernels keep
fp32).

``--mutants`` builds copies of ``csrc/flash_attention.cu`` with one fault
planted in the bf16 tensor-core kernel each (text substitutions, under
``build/flash_mutants/``) and prints for each the bf16 gradient reading
against the same CPU side: the bf16 gate has to sit between the sound
kernel's reading and theirs. Needs a CUDA card. ``PAGED_MUTANTS`` plants
faults in ``csrc/paged_decode.cu`` the same way. The forward errors of
every flash and paged-decode mutant at each phase-3 attention shape come
from ``chip_smoke.py --mutants``, which writes them to
``build/mutants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from repro_torch.configs import cut
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as paged_module
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.models import build_model
from repro_torch.training.trainer import extra_fields

# a leaf's max|Δg| over its max|g|, and the loss |Δ|, card against CPU. In
# bf16 a leaf's gradient is bf16-quantized, so a difference of one ulp at its
# largest element reads at most 2^-7 = 7.8e-3, under the gate. On an H100 80GB
# HBM3 (700 W) the sound kernel reads 5.2e-3 (one ulp, leaf mlp.w_up) and the
# subtlest planted fault (--mutants, softmax scale 1% high) 1.1e-2
GRAD_RTOL = {"float32": 1e-3, "bfloat16": 1e-2}
FLASH_BF16_TOL = (2e-2, 1e-2)  # tests/test_kernels.py::_tol, with rtol 1e-2
# one microbatch (B 2 of the global 4, T 512) of chip_smoke.py phase 6b's
# steps at the calls of the kernels: flash (B, T, S, H, K, hd, causal,
# window) for each attention call of a run, mamba2-1.3b's SSD (b, t, h, p,
# n, chunk) and recurrentgemma-9b's RG-LRU (B, T, W)
FLASH_TRAIN_CALLS = {
    "qwen3-4b": (2, 512, 512, 32, 8, 128, True, None),
    "recurrentgemma-9b": (2, 512, 512, 16, 1, 256, True, 2048),  # local attention, window ≥ T
    "granite-moe-1b-a400m": (2, 512, 512, 16, 8, 64, True, None),
    "qwen2-moe-a2.7b": (2, 512, 512, 16, 16, 128, True, None),
    "whisper-small encoder": (2, 1500, 1500, 12, 12, 64, False, None),
    "whisper-small cross": (2, 512, 1500, 12, 12, 64, False, None),
    "whisper-small decoder self": (2, 512, 512, 12, 12, 64, True, None),
}
SSD_TRAIN_SHAPE = (2, 512, 64, 64, 128, 256)
RGLRU_TRAIN_SHAPE = (2, 512, 4096)
# whisper-small's non-causal flash calls, (T, S) at H = K = 12, hd 64: the
# encoder's, and cross-attention of a 128-token prompt; 1500 = 23·64 + 28
WHISPER_SHAPES = ((1500, 1500), (128, 1500))
# a leaf whose max|g| on the CPU is below this share of the largest leaf's
# reads rounding noise only (a key bias's exact gradient is zero)
NOISE_FLOOR = 1e-6

_MMA_KERNEL = "__global__ void __launch_bounds__(NTM) flash_fwd_mma_kernel("
MUTANTS = {  # name: (old, new), substituted once in the bf16 tensor-core kernel
    "batch 1 reads batch 0's keys": ("ksrc = k + b * ks.b + s * ks.s", "ksrc = k + s * ks.s"),
    "last key tile dropped": ("(kv_end - kv_begin + BCM - 1) / BCM", "(kv_end - kv_begin - 1) / BCM"),
    "no rescale on a new row max": ("const float alpha = exp2f(m_run[hr] - m_new);",
                                    "const float alpha = 1.f;"),
    "softmax scale 1% high": ("const float scale_log2 = sm_scale *", "const float scale_log2 = 1.01f * sm_scale *"),
    "keys past S unmasked": ("ok = row_ok[hr] && s < kv_end;", "ok = row_ok[hr];"),
}


PAGED_MUTANTS = {  # name: (old, new), substituted once in csrc/paged_decode.cu (fp32 and bf16 alike)
    "combine drops split 0": ("const float w = expf(ml[s * 2 * G] - m_max);",
                              "const float w = s == 0 ? 0.f : expf(ml[s * 2 * G] - m_max);"),
    "last key tile of a split dropped": ("const int ntiles = (t1 - t0 + TILE - 1) / TILE;",
                                         "const int ntiles = (t1 - t0 - 1) / TILE;"),
    "length mask one past the end": ("const int len = max(0, min(lengths[b], a.maxp * a.page));",
                                     "const int len = max(0, min(lengths[b] + 1, a.maxp * a.page));"),
    "wrong page (page id + 1, clamped)": ("sPid[i] = min(max(page_table[b * a.pt_sb + first_page + i], 0), a.P - 1);",
                                          "sPid[i] = min(max(page_table[b * a.pt_sb + first_page + i] + 1, 0), a.P - 1);"),
}


def shift_mean(hd: int) -> float:
    """The q mean (k's is its negative) that puts each score 2.88 below the
    0 of a zero-filled key at head_dim ``hd``: a score averages
    −mean²·hd/√hd, 0.6 at hd 64, 0.505 at 128, 0.424 at 256."""
    return 0.6 * (64 / hd) ** 0.25


def shifted(rng, shape, mean: float, dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    return torch.from_numpy((rng.normal(size=shape) + mean).astype(np.float32)).to(device, dtype)


def shifted_qkv(rng, T: int, S: int, dtype=torch.bfloat16, device="cuda", H: int = 12, K: int = 12, hd: int = 64,
                B: int = 1):
    """q (B, T, H, hd), k and v (B, S, K, hd) for holding attention to a
    tolerance: q has mean ``shift_mean(hd)`` and k its negative in every
    component, so each real score sits about 2.9 below the 0 that a
    zero-filled key past S scores (such a key, left unmasked, takes a large
    share of its row's softmax) and scores stay O(1) at every head_dim; v has
    mean 1, so outputs are O(1) and the bf16 tolerance 2e-2 + 1e-2·|out| is
    ~3% of them. From N(0, 1) inputs the outputs are ~√(e/S): 0.04 at S 1500,
    where that tolerance is half of one."""
    mu = shift_mean(hd)
    return (shifted(rng, (B, T, H, hd), mu, dtype, device), shifted(rng, (B, S, K, hd), -mu, dtype, device),
            shifted(rng, (B, S, K, hd), 1.0, dtype, device))


def shifted_pages(rng, B: int, H: int, K: int, hd: int, P: int, page: int, dtype=torch.bfloat16, device="cuda"):
    """``shifted_qkv``'s draws for paged decode: q (B, H, hd) and the page
    pools k and v (P, page, K, hd)."""
    mu = shift_mean(hd)
    return (shifted(rng, (B, H, hd), mu, dtype, device), shifted(rng, (P, page, K, hd), -mu, dtype, device),
            shifted(rng, (P, page, K, hd), 1.0, dtype, device))


def models(dtype: str, arch: str = "qwen3-4b", n_layers: int = 2):
    cfg = cut(arch, n_layers, dtype=dtype)
    gpu = build_model(cfg, "cuda").init(torch.Generator(device="cuda").manual_seed(0)).requires_grad_()
    cpu = build_model(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    return cfg, gpu, cpu.requires_grad_()


def batch(cfg, B: int = 2, T: int = 512) -> dict:
    pipe = TokenPipeline(cfg.vocab, B, T, seed=0, extra_fields=extra_fields(cfg))
    return {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}


def gradients(model, data: dict) -> tuple[float, dict]:
    """The loss and every parameter's gradient (on the host), from zero."""
    dev = next(model.parameters()).device
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss({k: v.to(dev) for k, v in data.items()})
    loss.backward()
    return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}


def compare(card: tuple[float, dict], cpu: tuple[float, dict]) -> dict:
    """Each leaf's max|Δg| over its max|g| on the CPU; a leaf under
    ``NOISE_FLOOR`` of the largest max|g| is read over that largest. Such a
    leaf's exact gradient is zero, as a key bias's is (a row's softmax does
    not change when the same q·b_k is added to all its scores), and each side
    reads rounding noise there (~1e-9 against ~1e-2 elsewhere, in fp32 on
    the CPU)."""
    (lg, gg), (lc, gc) = card, cpu
    worst, zero = ("", 0.0), []
    top = max(c.abs().max().item() for c in gc.values())
    for name, c in gc.items():
        g, scale = gg[name], c.abs().max().item()
        if scale == 0 or g.abs().max().item() == 0:
            zero.append(name)
        if scale < NOISE_FLOOR * top:
            scale = top
        rel = (g - c).abs().max().item() / scale if scale else float("inf")
        worst = max(worst, (name, rel), key=lambda e: e[1])
    return {"loss_card": lg, "loss_cpu": lc, "loss_abs_err": abs(lg - lc), "worst_leaf": worst[0],
            "worst_rel_err": worst[1], "zero": zero}


def passes(reading: dict, dtype: str) -> bool:
    tol = GRAD_RTOL[dtype]
    return not reading["zero"] and reading["loss_abs_err"] <= tol and reading["worst_rel_err"] <= tol


def run(dtype: str, arch: str = "qwen3-4b", n_layers: int = 2) -> dict:
    """One reading of ``arch`` at ``n_layers``, card against CPU, with the
    kernel libraries as built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, gpu, cpu = models(dtype, arch, n_layers)
    data = batch(cfg)
    return compare(gradients(gpu, data), gradients(cpu, data))


def build_mutants(kernel: str = "flash_attention") -> dict[str, ctypes.CDLL]:
    """One library per mutant of ``kernel`` ("flash_attention": ``MUTANTS``,
    in the bf16 tensor-core kernel; "paged_decode": ``PAGED_MUTANTS``), one
    ``nvcc`` each, all started together."""
    src = (_build.CSRC / _build.SOURCES[kernel]).read_text()
    if kernel == "flash_attention":
        head, tail = src.split(_MMA_KERNEL)
        head, mutants = head + _MMA_KERNEL, MUTANTS
    else:
        head, tail, mutants = "", src, PAGED_MUTANTS
    out = _build.BUILD_DIR / f"{kernel}_mutants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (old, new)) in enumerate(mutants.items()):
        if tail.count(old) != 1:
            raise RuntimeError(f"mutant {name!r}: {old!r} is not once in {kernel}")
        cu, so = out / f"m{i}.cu", out / f"m{i}.so"
        cu.write_text(head + tail.replace(old, new))
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for mutant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def use(lib: ctypes.CDLL, kernel: str = "flash_attention") -> None:
    """Route ``kernel``'s wrapper to ``lib`` (a mutant, or the library as built)."""
    _build._loaded[kernel] = lib
    if kernel == "flash_attention":
        flash_module._fn = None
    else:
        paged_module._fn = None


def mutants() -> list[dict]:
    """The sound kernel's and each flash mutant's bf16 gradient gate readings,
    against one CPU side. Their forward errors at every phase-3 attention
    shape are ``chip_smoke.py --mutants``'s, in ``build/mutants.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"as built": _build.library("flash_attention"), **build_mutants()}
    cfg, gpu, cpu = models("bfloat16")
    data = batch(cfg)
    cpu_side = gradients(cpu, data)
    rows = []
    try:
        for name, lib in libs.items():
            use(lib)
            row = {"kernel": name, **compare(gradients(gpu, data), cpu_side)}
            row["gate"] = "pass" if passes(row, "bfloat16") else "fail"
            print(f"{name:30s} loss |d| "
                  f"{row['loss_abs_err']:.4g}, worst leaf {row['worst_leaf']} {row['worst_rel_err']:.4g}, "
                  f"zero {row['zero']}, bf16 gradient gate {GRAD_RTOL['bfloat16']:.0e}: {row['gate']}", flush=True)
            rows.append(row)
    finally:
        use(libs["as built"])
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--mutants", action="store_true", help="also read each planted flash fault (qwen3-4b)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_check needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{smi}]")
    for dtype in ("float32", "bfloat16"):
        r = run(dtype, args.arch, args.layers)
        print(f"{args.arch} {args.layers} layers {dtype}: {r} tol {GRAD_RTOL[dtype]:.0e} "
              f"{'ok' if passes(r, dtype) else 'FAIL'}", flush=True)
    if args.mutants:
        mutants()


if __name__ == "__main__":
    main()
