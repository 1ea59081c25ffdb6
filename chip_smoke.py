#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --mutants   # phase 3's attention checks on planted faults

Run from the root of a checkout. Phases, in order; any failure exits non-zero:

1. device: the card's name, count, and power limit;
2. build: every CUDA kernel from src/repro_torch/csrc with nvcc for sm_90a
   (one nvcc per source, all started together), registers and spills per
   instantiation, shared memory per block, and the tensor-core (HMMA)
   instructions in the SASS of the bf16 flash and SSD kernels, which must be
   there;
3. each kernel against its plain PyTorch version on the card, over the
   tests/test_kernels.py grids in fp32 and bf16, the attention kernels' edges
   (paged decode's per-split partials at every split boundary, flash in bf16
   at every head_dim with ragged T, windows under a tile and strided views,
   a CUDA-graph replay of each), the bf16 SSD kernels' tile edges and a
   CUDA-graph replay of the chunked SSD, the chunked RG-LRU kernel at its
   chunk and tile edges (T 8192, B 3 with h0, aligned views cut to a ragged
   W) and in long memory (a → 1, so every earlier chunk's fold shows) with
   two eager calls and a CUDA-graph replay bit-equal, and at the serving
   shapes of
   qwen3-4b (attention, head_dim 128), recurrentgemma-9b (attention at
   head_dim 256, RG-LRU) and mamba2-1.3b (SSD), with times of kernel, plain
   version and the PyTorch library call where one exists (a yardstick only:
   the port never calls it) beside the bound; flash also at every attention
   call of phase 6b's steps, one microbatch (B 2, T 512;
   ``grad_check.FLASH_TRAIN_CALLS``: qwen3-4b's H 32 on K 8 of 128,
   recurrentgemma-9b's 16 on 1 of 256 with window 2048, granite-moe-1b-a400m's
   16 on 8 of 64, qwen2-moe-a2.7b's 16 on 16 of 128, causal; whisper-small's
   12 on 12 of 64: non-causal over the encoder's 1500 frames, cross-attention
   of T 512 against S 1500, causal decoder self-attention) in fp32 and bf16
   (timed in bf16), the SSD kernels and the RG-LRU at the training
   steps' microbatch (mamba2-1.3b: B 2, T 512, 64 heads of 64, state 128,
   chunk 256; recurrentgemma-9b: B 2, T 512, W 4096; bf16, timed); both
   attention kernels at the MoE configs' heads (granite-moe-1b-a400m:
   head_dim 64, 2 query heads per kv head;
   qwen2-moe-a2.7b: head_dim 128, no grouping) in fp32 and bf16, then
   checked and timed at their serving shapes; both at whisper-small's
   (head_dim 64, no grouping) in fp32 and bf16, on inputs whose outputs are
   O(1) and where an unmasked key past S would show: flash non-causal over the
   encoder's 1500 frames and for cross-attention (T 128 against S 1500),
   causal at the decoder's prompt, paged decode over the 1500-slot cross
   cache (one page of 1500) and the 256-slot self cache, each timed, with a
   CUDA-graph replay of the cross shapes; every attention input is drawn with
   O(1) outputs and O(1) scores at its head_dim (``grad_check.shifted_qkv``,
   ``shifted_pages``), so that the bf16 tolerance is a few percent of an
   output (``--mutants`` runs these checks on each fault planted in the bf16
   flash kernel and in paged decode, and every fault has to fail them); the
   MoE's two row-gather kernels (``csrc/moe_gather.cu``) bit-equal to their
   plain versions at qwen2-moe's and granite-moe's widths in fp32 and bf16,
   then timed at the benchmark cells' microbatches in bf16 beside
   ``index_select``, ``index_add_`` and the ``index_put_`` accumulation that
   advanced indexing's backward ran before them;
4. model parity, card (kernels) against CPU (plain path), fp32, one set of
   seeded weights drawn on the card, full width cut in depth: qwen3-4b (2
   layers) with a 64-token prefill, mamba2-1.3b (2 layers) with a 512-token
   prefill (2 chunks of 256) and recurrentgemma-9b (3 layers, one RRA group)
   with a 2048-token prefill, each followed by 4 teacher-forced decode steps
   (recurrentgemma's wrap its 2048-slot ring), granite-moe-1b-a400m and
   qwen2-moe-a2.7b (2 layers each; the MoE's dispatch and combine the row-gather
   kernels on the card, their plain versions on the CPU) with
   a 64-token prefill, whisper-small (2 encoder and 2 decoder layers) with
   seeded frame embeddings over its 1500 positions and a 64-token prefill,
   logits compared; then the
   bf16 path that serves (bf16 weights), card against CPU at the same
   depths and prompts, recorded and not gated: the logits' max|Δ| and the
   first of 8 greedy decode steps whose tokens differ;
   mesh: the distribution layer (``phase_mesh``): a 1-rank NCCL group and a
   (1, 1) ``DeviceMesh``; qwen3-4b and granite-moe-1b-a400m (2 layers, bf16)
   with every ``PerfConfig`` flag on and the KV cache placed on the mesh,
   greedy tokens equal to the run without a mesh, each explicit path's calls
   counted; ``compressed_psum`` over a qwen3-4b layer's gradient shapes,
   card through NCCL bit-equal to the CPU through gloo; a 1-layer qwen3-4b
   train state saved into the port's BVLSM engine on disk
   (``BVCheckpointStore(path)``) and restored onto the mesh with
   ``load_distributed``, every leaf equal; then, in a child process with
   deterministic algorithms (``mesh_train_check``), ``Trainer(mesh=...)``
   on qwen3-4b and granite-moe-1b-a400m (2 layers, 3 steps of 4 × 512)
   against the trainer without a mesh, every leaf bit-equal but the tied
   embedding and its moments (within ``MESH_TRAIN_RTOL``), the kernels'
   launches and V9's and V2's calls counted, and granite-moe saved at step
   2 and resumed by a fresh ``Trainer(mesh=...)`` to a step 3 bit-equal;
5. serving: ``repro_torch.launch.serve`` at full width and depth in bf16:
   qwen3-4b (8 requests, prompt 128, 32 new tokens, max batch 4), then
   mamba2-1.3b (8 requests, prompt 1024, max_len 1280), then
   recurrentgemma-9b (8 requests, prompt 2048, max_len 2112: decode
   overwrites ring slots), then granite-moe-1b-a400m and qwen2-moe-a2.7b
   (24 layers each; 8 requests, prompt 128, 32 new tokens, max batch 4,
   max_len 256), then whisper-small (12 + 12 layers, the same requests,
   zero frames as the engine serves); before each run every launch count
   is set to 0,
   and after it each kernel's count is checked against the layers of its
   kind times the prefill or decode calls, and peak memory against 80 GB;
6. training: (a) the gradient check, card (flash kernel forward,
   ``ops.Attention``'s backward) against CPU (the jnp-body port under
   autograd), full width at 2 layers, gated in fp32 and in bf16 compute:
   every leaf's gradient nonzero on both sides, loss |Δ| and each leaf's
   max|Δ| over its max|g| ≤ 1e-3 in fp32 and ≤ 1e-2 in bf16
   (``launch/grad_check.py``, which also reads planted flash faults), and
   granite-moe-1b-a400m the same way in fp32 (the router's gradient through
   the gates and the aux loss, every leaf nonzero), and whisper-small at 2 +
   2 layers in fp32 (``ops.Attention``'s backward non-causal with T ≠ S in
   cross-attention; its key biases read over the model's scale, see
   ``grad_check.compare``), and qwen2-moe-a2.7b the same way in fp32 (its 4
   shared experts and their gate, 60 routed experts, the qkv biases), then
   mamba2-1.3b at 2 layers (the SSD kernels'
   forward, ``ops.SSDScan``'s backward) and recurrentgemma-9b at 3 (R, R,
   A: the RG-LRU kernel's forward, ``ops.RGLRU``'s backward, flash at hd
   256), gated in fp32 with every leaf nonzero (``A_log``, ``dt_bias``,
   ``D``, the conv weights and ``lam`` among them), mamba2-1.3b recorded in
   bf16 (ROADMAP Queue C 11); (b) 4 steps through ``make_train_step``, fp32
   masters, bf16 compute, AdamW, remat, global batch 4 × 512 in 2
   microbatches (whisper's with its 1500 frame embeddings a row), the
   caching allocator's segments growing in place as ``launch/train.py``
   trains (``train_allocator``), every launch count set to 0 just before
   each model: a finite loss at every step, each kernel launched exactly as
   ``cost.train_step_launches`` counts (once per layer of its kind per
   forward and per remat recompute) and no other kernel, step ms, tokens/s
   and peak allocated and reserved memory under 80 GB, and one more step
   counted as the dry run counts; at full width (``TRAIN_RUNS``): qwen3-4b
   at full depth (36 layers, 4.02 B parameters: flash 36 × 2 × 2 × 4 =
   576), mamba2-1.3b at full depth (48 layers, 1.34 B: ``ssd_states`` =
   ``ssd_output`` = 768), recurrentgemma-9b cut to 9 layers (3 R, R, A
   groups, 4.07 B: ``rglru_scan`` 96, flash 48; its 38 layers need ~167 GB
   of state), granite-moe-1b-a400m at full depth (24 layers, 1.33 B: flash
   384), whisper-small at full depth (12 + 12 layers, 0.27 B: flash (12 +
   2 × 12) × 16 = 576) and qwen2-moe-a2.7b cut to 6 layers (flash 96; its
   24 layers need ~229 GB);
   dryrun: ``repro_torch.launch.dryrun`` over every arch × shape on both
   production layouts on the meta device (every cell ok or skip), and each
   of (b)'s runs on one rank at its shape, both in a child process without
   the card, started after phase 3, that runs beside the card phases with
   6d's harnesses; each run's record held against (b): argument bytes
   within 1% of what ``init_state`` allocated, the FLOPs of one step meta
   and card exactly equal; the predicted total and its fit at 80 GB beside
   (b)'s peak, and ``train_mfu``, recorded; (c) in a child process with deterministic algorithms,
   ``launch/train.py``'s trainer at full width and 1 layer, checkpointing
   into the port's BVLSM engine (``repro_torch.core``) in a fresh directory
   of the checkout (``build/ckpt``): 4 steps straight against 2, then a new
   trainer that re-opens the directory (recovery from WAL and MANIFEST) and
   resumes for 2 more, every leaf of the state bit-equal and the engine's
   scrub (``verify_integrity``) clean; it prints the directory's filesystem
   (from /proc/mounts) and free bytes, the bytes of state saved, save and
   stall seconds, and the engine's bytes by kind and write amplification;
   (d) the rest of the storage engine: the port's harnesses under build/ckpt
   (``repro_torch.testing.model_db`` on one engine and on a 3-shard
   ``ShardedDB``, ``crash_harness`` and ``failover_harness`` in sync and
   async WAL modes: no divergence or violation; run by the dry run's child
   process), then, in another child process, (c)'s trainer for 2 steps checkpointing into a 4-shard
   ``ShardedDB`` on the store's own config (``bvstore.store_config``) and a
   new trainer restoring from the re-opened router, then into a primary
   ``DB`` with a replica bootstrapped and attached, the primary crashed once
   the replica caught up (lag 0), the replica promoted and a new trainer
   restoring from it: every leaf bit-equal to a CPU copy taken at the save,
   every scrub clean, every shard holding BValue bytes; it prints save,
   stall, catch-up, promote and restore seconds, the router's engine
   counters, the bytes and frames shipped and the value bytes mirrored, and
   the bytes 6c and 6d wrote (a run should stay under 45 GiB of writes);
7. the whole run's seconds, a ``kernels:`` summary line (launches and
   max|Δ| per kernel), the JSON
   line ``{"kernels": [...]}`` with every measured number, then the result
   line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import dist as rdist  # noqa: E402
from repro_torch.configs import cut, get_config  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.dist.perf import PerfConfig, perf_context  # noqa: E402
from repro_torch.kernels import _build, cost, decode_attention, moe_gather, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash_module  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.decode_attention import paged_decode_attention, paged_decode_partials  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import inter_chunk_scan, ssd_chunked_cuda, ssd_output, ssd_states  # noqa: E402
from repro_torch.checkpoint.bvstore import BVCheckpointStore, store_config  # noqa: E402
from repro_torch.core import DB, InProcessTransport, ShardedDB, attach, bootstrap_replica  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeCell  # noqa: E402
from repro_torch.launch import dryrun, grad_check, serve, specs, train  # noqa: E402
from repro_torch.launch.mesh import H100, MeshLayout, make_host_mesh  # noqa: E402
from repro_torch.models import attention, build_model, moe, transformer  # noqa: E402
from repro_torch.training import compression  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.training.train_step import TrainConfig, init_state, make_train_step, state_axes  # noqa: E402
from repro_torch.training.trainer import Trainer, extra_fields  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# FLOP/s, fp32 FLOP/s outside the tensor cores
PEAK_BYTES = H100["hbm_bw"]
PEAK_FLOPS = {torch.bfloat16: H100["peak_flops_bf16"], torch.float32: H100["peak_flops_fp32"]}

FLASH_GRID = [  # tests/test_kernels.py
    (2, 256, 8, 4, 64, True, None),
    (1, 384, 4, 1, 128, True, None),
    (2, 256, 8, 8, 64, False, None),
    (1, 512, 4, 2, 64, True, 128),
    (1, 200, 4, 2, 64, True, None),
    (1, 256, 2, 2, 32, True, None),
]
PAGED_GRID = [(2, 8, 4, 64, 16, 128, 4), (4, 4, 1, 128, 32, 128, 6), (2, 16, 8, 64, 16, 256, 3)]
# (b, t, h, p, n, chunk): tests/test_kernels.py::test_ssd_chunk_sweep, a
# ragged t at chunk 100, and the serving shape of mamba2-1.3b (prompt 1024)
SSD_GRID = [(1, 128, 4, 32, 64, 32), (2, 256, 2, 64, 128, 64), (1, 64, 8, 16, 32, 64),
            (1, 300, 2, 64, 128, 100)]
SSD_SERVING = (1, 1024, 64, 64, 128, 256)
# the bf16 tensor-core kernels' tile edges: t not a multiple of 16 or 64,
# chunks of 45 and 100, n of 16, 24 and 256, p of 16 and 128
SSD_EDGES = [(1, 77, 2, 16, 16, 32), (1, 45, 3, 64, 128, 45), (1, 333, 2, 128, 24, 64),
             (1, 260, 2, 128, 256, 100)]
# (B, T, W): tests/test_kernels.py::test_rglru_sweep, then a ragged T and W;
# then the chunked kernel's edges (chunks of 128 steps, tiles of 32
# channels): T under one chunk, one under and one over it, a ragged last
# chunk with W past a tile (rows not 16-byte aligned: plain loads), T 8192,
# and W 4100 over 129 tiles
RGLRU_GRID = [(2, 128, 256), (1, 256, 512), (1, 300, 200), (3, 5, 7), (2, 127, 128), (2, 129, 384),
              (1, 1000, 130), (1, 8192, 1024), (1, 97, 4100)]
# (B, T, W, h0 given): long memory (rglru_inputs(long_memory=True)), where
# every earlier chunk's carry and h0's reach the last chunk: T 8192 is 64
# chunks, so the last one folds 8 runs of 8; B 3 with h0 over 8 chunks
RGLRU_LONG = [(1, 8192, 256, False), (3, 1000, 300, True)]
RGLRU_SERVING = (1, 2048, 4096)  # recurrentgemma-9b, prompt 2048
TOL = {torch.float32: (2e-5, 1e-2), torch.bfloat16: (2e-2, 1e-2)}  # tests/test_kernels.py::_tol
SSD_TOL = {torch.float32: (5e-4, 1e-3), torch.bfloat16: (2e-2, 1e-2)}  # test_ssd_chunk_sweep's; bf16 y
PARITY_ATOL = 5e-3  # phase 4, see there
MEMORY_LIMIT = 80e9  # phase 6b: bytes, one card
TRAIN_B, TRAIN_T = 4, 512  # phase 6b's global batch
TRAIN_CFG = TrainConfig(opt=OptimizerConfig(warmup_steps=2, total_steps=100), accum_steps=2, remat=True)
ARGS_RTOL = 0.01  # phase dryrun: predicted argument bytes against the allocation (allocator rounding)
KERNELS = {
    "flash_attention": dict(route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:152"),
    "paged_decode": dict(route="cuda", source="src/repro_torch/csrc/paged_decode.cu",
                         replaces="src/repro/kernels/decode_attention.py:111"),
    "ssd_states": dict(route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
                       replaces="src/repro/kernels/ssd_scan.py:85"),
    "ssd_output": dict(route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
                       replaces="src/repro/kernels/ssd_scan.py:117"),
    "rglru_scan": dict(route="cuda", source="src/repro_torch/csrc/rglru_scan.cu",
                       replaces="src/repro/kernels/rglru_scan.py:68"),
    # no TPU kernel: the MoE's advanced indexing and its index_put_ backward
    "gather_rows": dict(route="cuda", source="src/repro_torch/csrc/moe_gather.cu", replaces=None),
    "gather_sum_rows": dict(route="cuda", source="src/repro_torch/csrc/moe_gather.cu", replaces=None),
}
WRAPPERS = {"flash_attention": flash_attention, "paged_decode": paged_decode_attention,
            "ssd_states": ssd_states, "ssd_output": ssd_output, "rglru_scan": rglru_scan,
            "gather_rows": moe_gather.gather_rows, "gather_sum_rows": moe_gather.gather_sum_rows}


def randn(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)


# ``--mutants`` sets RECORD to a list: every check appends (name, max|Δ|/tol,
# max|Δ|) there and raises nothing; TIMED False skips the timings
RECORD: list | None = None
TIMED = True


def check(name, out, expect, tol, quiet=False) -> float:
    """max|Δ| of kernel output against its plain version; raises past
    ``tol = (atol, rtol)`` (records instead under ``--mutants``)."""
    torch.cuda.synchronize()
    atol, rtol = tol
    if out.shape != expect.shape or out.dtype != expect.dtype:
        raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype} vs plain {tuple(expect.shape)} {expect.dtype}")
    diff = (out.float() - expect.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    ratio = (diff / (atol + rtol * expect.float().abs())).nan_to_num(nan=float("inf"))
    ratio = ratio.max().item() if ratio.numel() else 0.0
    if RECORD is not None:
        RECORD.append((name, ratio, err))
        return err
    ok = ratio <= 1.0
    if not quiet or not ok:
        print(f"  {name}: max|d|={err:.3e} atol={atol:.0e} rtol={rtol:.0e} {'ok' if ok else 'FAIL'}")
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


def eager_ms(fn, iters=200, warmup=10) -> float:
    """Time per call of back-to-back eager calls: the larger of the host's
    launch cost and the device time."""
    for _ in range(warmup):
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


def timings(kernel, plain, library=None, iters=100, plain_iters=100) -> dict:
    """``library`` None: no single PyTorch call computes the function. Fewer
    ``iters`` for calls of milliseconds; fewer ``plain_iters`` for a plain
    version of thousands of launches (a CUDA graph holds them all)."""
    if not TIMED:
        return {}
    t = dict(ms=device_ms(kernel, iters), plain_ms=device_ms(plain, plain_iters, min(5, plain_iters)),
             library_ms=device_ms(library, iters) if library else None,
             eager_ms=eager_ms(kernel, 2 * iters),
             plain_eager_ms=eager_ms(plain, min(50, plain_iters), min(10, plain_iters)),
             library_eager_ms=eager_ms(library, 2 * iters) if library else None)
    print("  " + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} none" for k, v in t.items()))
    return t


def bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[1 device] {name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s wall, nvcc {' '.join(_build.NVCC_FLAGS)}")
    for rep in reports.values():
        print(f"  {rep.name}: {rep.seconds:.1f} s -> {rep.path.name}")
        for line in rep.resources():
            print(f"    {line}")
    if not any("spill" in line for rep in reports.values() for line in rep.resources()):
        print("    no kernel spills registers")
    # the bf16 flash and SSD kernels' products must run on the tensor cores
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib in ("flash_attention", "ssd_scan"):
        sass = subprocess.run([tool, "-sass", str(reports[lib].path)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
        n_hmma, n_hgmma = sass.count("HMMA"), sass.count("HGMMA")
        print(f"  {lib} SASS: {n_hmma} HMMA, {n_hgmma} HGMMA instructions")
        if n_hmma + n_hgmma == 0:
            raise AssertionError(f"{lib}: no tensor-core instruction in the SASS")
    hds = (16, 32, 64, 128, 256)
    print("  dynamic shared memory per block: flash_attention bf16 (tensor cores) "
          + ", ".join(f"hd {hd}: {flash_module.shared_memory_bytes(hd)} B" for hd in hds)
          + "; fp32 (CUDA cores) "
          + ", ".join(f"hd {hd}: {flash_module.shared_memory_bytes(hd, torch.float32)} B" for hd in hds))
    print("  paged_decode partial kernel, bf16 pages of 64, 16-token splits: G=4 "
          + ", ".join(f"hd {hd}: {decode_attention.shared_memory_bytes(hd, 4)} B" for hd in hds)
          + f"; hd 256, G=16 (recurrentgemma-9b): {decode_attention.shared_memory_bytes(256, 16)} B"
          + f"; hd 256, G=64, fp32 pages: {decode_attention.shared_memory_bytes(256, 64, torch.float32)} B")
    for dtype, kind in ((torch.bfloat16, "bf16 (tensor cores)"), (torch.float32, "fp32 (CUDA cores)")):
        print(f"  ssd_states, ssd_output {kind}: "
              + "; ".join(f"p {p}, n {n}: %s B" % (ssd_scan.shared_memory_bytes(p, n, dtype),)
                          for p, n in ((64, 128), (128, 256), (16, 16))))


def phase_kernels() -> dict:
    print("[3 kernels vs plain versions]")
    rng = np.random.default_rng(0)
    results = phase_attention_kernels(rng)
    results.update(phase_ssd_kernels(rng))
    results.update(phase_rglru_kernel(rng))
    results.update(phase_moe_gathers(rng))
    return results


def phase_attention_kernels(rng) -> dict:
    """Every check of the two attention kernels in phase 3 (``--mutants``
    runs these on each planted fault): the tests/test_kernels.py grids, the
    edges, and the serving, training, head_dim-256, MoE and whisper shapes,
    timed there. The inputs are ``grad_check.shifted_qkv`` / ``shifted_pages``
    draws: outputs and scores O(1) at every head_dim, so that the bf16
    tolerance is a few percent of an output and a key left unmasked or
    dropped shows. Returns {kernel: numbers}."""
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, H, K, hd, causal, window in FLASH_GRID:
            q, k, v = grad_check.shifted_qkv(rng, T, T, dtype, B=B, H=H, K=K, hd=hd)
            check(f"flash {B},{T},{H},{K},{hd} causal={causal} window={window} {dtype}",
                  flash_attention(q, k, v, causal=causal, window=window),
                  ref.mha_reference(q, k, v, causal=causal, window=window), TOL[dtype])
        for B, H, K, hd, P, page, maxp in PAGED_GRID:
            q, pk, pv = grad_check.shifted_pages(rng, B, H, K, hd, P, page, dtype)
            pt = torch.from_numpy(rng.integers(0, P, size=(B, maxp)).astype(np.int32)).cuda()
            lens = torch.from_numpy(rng.integers(1, maxp * page, size=(B,)).astype(np.int32)).cuda()
            check(f"paged {B},{H},{K},{hd},{P},{page},{maxp} {dtype}",
                  paged_decode_attention(q, pk, pv, pt, lens),
                  ref.paged_decode_reference(q, pk, pv, pt, lens), TOL[dtype])

    phase_attention_edges(rng)

    results = {}
    flash, paged = attention_serving_shapes(rng, "qwen3-4b", 32, 8, 128)
    results["flash_attention"], results["paged_decode"] = flash, paged
    # phase 6b's flash calls (their own generators: the later checks keep their inputs)
    for seed, (name, call) in enumerate(grad_check.FLASH_TRAIN_CALLS.items(), 1):
        results["flash_attention"][training_key(name)] = flash_training(np.random.default_rng(seed), name, call)

    hd256 = phase_hd256_kernels(rng)
    results["flash_attention"]["hd256"] = hd256["flash_attention"]
    results["paged_decode"]["hd256"] = hd256["paged_decode"]
    for name, by_arch in phase_moe_head_kernels(rng).items():
        results[name].update(by_arch)
    for name, numbers in phase_whisper_kernels(rng).items():
        results[name]["whisper-small"] = numbers
    return results


def training_key(call: str) -> str:
    """The kernels line's flash entry of a phase-6b call
    (``grad_check.FLASH_TRAIN_CALLS``): "training" for qwen3-4b's, "hd256
    training" for recurrentgemma-9b's, else "<call> training"."""
    return {"qwen3-4b": "training", "recurrentgemma-9b": "hd256 training"}.get(call, f"{call} training")


def flash_training(rng, name: str, call) -> dict:
    """Flash at one microbatch of a phase-6b step's attention call ``name``,
    ``call`` = (B, T, S, H, K, hd, causal, window): checked against its plain
    version in fp32 (the CUDA-core kernel) and bf16 (the tensor-core one),
    then timed in bf16, the step's compute dtype, beside its bound and SDPA."""
    B, T, S, H, K, hd, causal, window = call
    # SDPA's is_causal keeps the same pairs: causal calls have T = S and no window under T
    assert not causal or (T == S and (window is None or window >= T))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = grad_check.shifted_qkv(rng, T, S, dtype, B=B, H=H, K=K, hd=hd)
        errs[dtype] = check(f"flash {name} training call {B},{T},{S},{H},{K},{hd} causal={causal} window={window} "
                            f"{dtype}", flash_attention(q, k, v, causal=causal, window=window),
                            ref.mha_reference(q, k, v, causal=causal, window=window), TOL[dtype])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flops, nbytes = cost.flash_attention(q, k, v, causal=causal, window=window)
    bound_ms, by = bound(nbytes, flops, torch.bfloat16)
    print(f"  flash {name} training call bf16, ms per call (sdpa = library yardstick), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t = timings(lambda: flash_attention(q, k, v, causal=causal, window=window),
                lambda: ref.mha_reference(q, k, v, causal=causal, window=window),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True), plain_iters=20)
    return dict(max_abs_err=errs[torch.bfloat16], max_abs_err_float32=errs[torch.float32], bound_ms=bound_ms,
                bound_by=by, **t)


# paged decode's partials at their edges: (B, H, K, hd, P, page, maxp, split
# tokens, identity page table): recurrentgemma-9b's ring view, B 3 x K 2 over a
# random page table, G 64
PAGED_EDGES = [(1, 16, 1, 256, 32, 64, 32, 16, True), (3, 8, 2, 64, 20, 16, 6, 32, False),
               (2, 64, 1, 128, 8, 16, 4, 16, False)]


def graph_replay_matches(name, fn) -> None:
    """One CUDA-graph capture of ``fn`` and two replays give its eager result
    bit for bit (the kernels are deterministic; workspaces come from the
    graph's pool)."""
    first = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, first):
        raise AssertionError(f"{name}: CUDA-graph replay differs from the eager call")
    print(f"  {name}: CUDA-graph replay equals the eager call ok")


def phase_attention_edges(rng) -> None:
    """The redesigned attention kernels at their edges. Paged decode: the
    partial kernel's (m, l, acc) against their plain version, so that a fault
    in the partials is told apart from one in the combine, and the combined
    output against the plain decode, at lengths 0, 1, 15, 16, 17, every split
    boundary (and one past it) and the capacity. Flash in bf16 (tensor cores)
    at every head_dim: T not a multiple of 16 or 64, non-causal, a window under
    one tile, q/k/v as strided views of one tensor. Then a CUDA-graph replay
    of each wrapper."""
    f32 = TOL[torch.float32]  # the partials are fp32 on both sides, from the same inputs
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, K, hd, P, page, maxp, split_len, identity in PAGED_EDGES:
            q, pk, pv = grad_check.shifted_pages(rng, B, H, K, hd, P, page, dtype)
            if identity:
                pt = torch.arange(B * maxp, dtype=torch.int32, device="cuda").view(B, maxp)
            else:
                pt = torch.from_numpy(rng.integers(0, P, size=(B, maxp)).astype(np.int32)).cuda()
            cap = maxp * page
            edges = sorted({0, 1, 15, 16, 17, cap} | {min(e, cap) for s in range(1, -(-cap // split_len) + 1)
                                                       for e in (s * split_len, s * split_len + 1)})
            errs = [0.0] * 4
            for length in edges:
                lens = torch.tensor([(length + i * 7) % (cap + 1) for i in range(B)], dtype=torch.int32, device="cuda")
                m, l, acc, out = paged_decode_partials(q, pk, pv, pt, lens, split_len)
                mr, lr, ar = ref.paged_decode_partials_reference(q, pk, pv, pt, lens, split_len)
                expect = ref.paged_decode_reference(q, pk, pv, pt, lens)
                for i, (name, x, y, tol) in enumerate((("m", m, mr, f32), ("l", l, lr, f32), ("acc", acc, ar, f32),
                                                        ("out", out, expect, TOL[dtype]))):
                    errs[i] = max(errs[i], check(f"paged partials {B},{H},{K},{hd} {name} {dtype} at lengths "
                                                 f"{lens.tolist()}", x, y, tol, quiet=True))
            print(f"  paged partials {B},{H},{K},{hd},{P},{page},{maxp} split {split_len} {dtype}, "
                  f"{len(edges)} length sets: max|d| m {errs[0]:.2e} l {errs[1]:.2e} acc {errs[2]:.2e} "
                  f"out {errs[3]:.2e} ok")
    dt = torch.bfloat16
    for hd in (16, 32, 64, 128, 256):
        for B, T, H, K, causal, window in ((1, 77, 4, 2, True, None), (2, 50, 4, 4, False, None),
                                           (1, 100, 4, 1, True, 5), (1, 130, 8, 2, False, 9)):
            q, k, v = grad_check.shifted_qkv(rng, T, T, dt, B=B, H=H, K=K, hd=hd)
            check(f"flash bf16 {B},{T},{H},{K},{hd} causal={causal} window={window}",
                  flash_attention(q, k, v, causal=causal, window=window),
                  ref.mha_reference(q, k, v, causal=causal, window=window), TOL[dt])
        mu = grad_check.shift_mean(hd)  # q, k and v as shifted_qkv draws them, in one tensor
        means = torch.tensor([mu] * 8 + [-mu] * 2 + [1.0] * 2).view(1, 1, 12, 1)
        qkv = (torch.from_numpy(rng.normal(size=(2, 70, 12, hd)).astype(np.float32)) + means).to("cuda", dt)
        q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
        check(f"flash bf16 strided views of one (2,70,12,{hd}) tensor", flash_attention(q, k, v),
              ref.mha_reference(q, k, v), TOL[dt])
    q, k, v = (randn(rng, (1, 300, 16, 256), dt), randn(rng, (1, 300, 1, 256), dt), randn(rng, (1, 300, 1, 256), dt))
    graph_replay_matches("flash_attention", lambda: flash_attention(q, k, v, window=128))
    qd = randn(rng, (2, 16, 256), dt)
    pk, pv = randn(rng, (16, 64, 1, 256), dt), randn(rng, (16, 64, 1, 256), dt)
    pt = torch.from_numpy(rng.integers(0, 16, size=(2, 8)).astype(np.int32)).cuda()
    lens = torch.tensor([0, 300], dtype=torch.int32, device="cuda")
    graph_replay_matches("paged_decode_attention", lambda: paged_decode_attention(qd, pk, pv, pt, lens))


def phase_hd256_kernels(rng) -> dict:
    """Both attention kernels at head_dim 256 with recurrentgemma-9b's MQA
    (16 query heads on 1 kv head): checked on small cases, then checked and
    timed at its serving shapes (a 2048-token prefill with window 2048; decode
    over the full 2048-slot ring)."""
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, window in ((1, 256, None), (1, 512, 128), (2, 200, None)):
            q, k, v = grad_check.shifted_qkv(rng, T, T, dtype, B=B, H=16, K=1, hd=256)
            check(f"flash hd 256 {B},{T},16,1 window={window} {dtype}",
                  flash_attention(q, k, v, window=window), ref.mha_reference(q, k, v, window=window), TOL[dtype])
        q, pk, pv = grad_check.shifted_pages(rng, 2, 16, 1, 256, 16, 64, dtype)
        pt = torch.from_numpy(rng.integers(0, 16, size=(2, 6)).astype(np.int32)).cuda()
        lens = torch.tensor([1, 6 * 64], dtype=torch.int32, device="cuda")
        check(f"paged hd 256 2,16,1,16,64,6 {dtype}", paged_decode_attention(q, pk, pv, pt, lens),
              ref.paged_decode_reference(q, pk, pv, pt, lens), TOL[dtype])

    dt = torch.bfloat16
    out = {}
    B, T, H, K, hd, W = 1, 2048, 16, 1, 256, 2048
    q, k, v = grad_check.shifted_qkv(rng, T, T, dt, B=B, H=H, K=K, hd=hd)
    err = check("flash hd 256 serving shape (window 2048)", flash_attention(q, k, v, window=W),
                ref.mha_reference(q, k, v, window=W), TOL[dt])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flops, nbytes = cost.flash_attention(q, k, v, window=W)  # window 2048 = T: every causal pair
    bound_ms, by = bound(nbytes, flops, dt)
    print(f"  flash hd 256 serving shape, ms per call (sdpa = library yardstick), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t = timings(lambda: flash_attention(q, k, v, window=W), lambda: ref.mha_reference(q, k, v, window=W),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
                iters=10, plain_iters=10)
    out["flash_attention"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)

    S, page = 2048, 64
    q, kc, vc = grad_check.shifted_qkv(rng, 1, S, dt, B=1, H=H, K=K, hd=hd)
    q = q.view(1, H, hd)
    pk, pv = kc.view(S // page, page, K, hd), vc.view(S // page, page, K, hd)
    pt = torch.arange(S // page, dtype=torch.int32, device="cuda").view(1, -1)
    err = 0.0
    for length in (0, 1, 63, 64, 1000, 2047, 2048):
        lens = torch.tensor([length], dtype=torch.int32, device="cuda")
        err = max(err, check(f"paged hd 256 ring view, length {length}", paged_decode_attention(q, pk, pv, pt, lens),
                             ref.paged_decode_reference(q, pk, pv, pt, lens), TOL[dt]))
    lens = torch.tensor([S], dtype=torch.int32, device="cuda")
    qs, ks, vs = q.view(1, H, 1, hd), kc.transpose(1, 2), vc.transpose(1, 2)
    flops, nbytes = cost.paged_decode(q, pk, pv, pt, lens)
    bound_ms, by = bound(nbytes, flops, dt)
    print(f"  paged hd 256 over the full 2048-slot ring, ms per call (sdpa = library yardstick), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t = timings(lambda: paged_decode_attention(q, pk, pv, pt, lens),
                lambda: ref.paged_decode_reference(q, pk, pv, pt, lens),
                lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True))
    out["paged_decode"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)
    return out


def attention_serving_shapes(rng, arch: str, H: int, K: int, hd: int) -> tuple[dict, dict]:
    """Both attention kernels at a serving path's shapes in bf16, checked and
    timed: flash over a 128-token causal prompt (B 1), paged decode over a
    256-slot cache of identity pages of 64 (every length 0..256 checked,
    timed at 160), each beside its bound, its plain version and SDPA.
    Returns the (flash, paged decode) numbers."""
    dt = torch.bfloat16
    tag = f"{arch} (hd {hd}, {H} on {K} kv heads)"
    B, T = 1, 128
    q, k, v = grad_check.shifted_qkv(rng, T, T, dt, B=B, H=H, K=K, hd=hd)
    err = check(f"flash {tag} serving shape", flash_attention(q, k, v), ref.mha_reference(q, k, v), TOL[dt])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flops, nbytes = cost.flash_attention(q, k, v)
    bound_ms, by = bound(nbytes, flops, dt)
    print(f"  flash {tag} serving shape, ms per call (sdpa = library yardstick), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t = timings(lambda: flash_attention(q, k, v), lambda: ref.mha_reference(q, k, v),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
    flash = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)

    S, page = 256, 64
    q, kc, vc = grad_check.shifted_qkv(rng, 1, S, dt, B=1, H=H, K=K, hd=hd)
    q = q.view(1, H, hd)
    pk, pv = kc.view(S // page, page, K, hd), vc.view(S // page, page, K, hd)
    pt = torch.arange(S // page, dtype=torch.int32, device="cuda").view(1, -1)
    err = 0.0
    for length in range(0, S + 1):
        lens = torch.tensor([length], dtype=torch.int32, device="cuda")
        err = max(err, check(f"paged decode {tag} serving shape at length {length}",
                             paged_decode_attention(q, pk, pv, pt, lens),
                             ref.paged_decode_reference(q, pk, pv, pt, lens), TOL[dt], quiet=True))
    print(f"  paged {tag} serving shape, lengths 0..{S}: max|d|={err:.3e} atol={TOL[dt][0]:.0e} ok")
    L = 160
    lens = torch.tensor([L], dtype=torch.int32, device="cuda")
    qs, ks, vs = q.view(1, H, 1, hd), kc[:, :L].transpose(1, 2), vc[:, :L].transpose(1, 2)
    flops, nbytes = cost.paged_decode(q, pk, pv, pt, lens)
    bound_ms, by = bound(nbytes, flops, dt)
    print(f"  paged {tag} serving shape at length {L}, ms per call (sdpa = library yardstick), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t = timings(lambda: paged_decode_attention(q, pk, pv, pt, lens),
                lambda: ref.paged_decode_reference(q, pk, pv, pt, lens),
                lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True))
    return flash, dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)


# the MoE configs' attention heads: (arch, H, K, hd)
MOE_HEADS = [("granite-moe-1b-a400m", 16, 8, 64), ("qwen2-moe-a2.7b", 16, 16, 128)]


def phase_moe_head_kernels(rng) -> dict:
    """Both attention kernels at the MoE configs' head shapes, new to the
    card with this slice: granite-moe-1b-a400m's hd 64 with 2 query heads per
    kv head, qwen2-moe-a2.7b's hd 128 with no grouping (G 1). In fp32 and
    bf16: flash causal at T 128 (the serving prefill), ragged T 77 at B 2 and
    non-causal T 100; paged decode at B 3 over a random page table. Then at
    the serving shapes (``attention_serving_shapes``). Returns {kernel:
    {arch: numbers}}."""
    out = {"flash_attention": {}, "paged_decode": {}}
    for arch, H, K, hd in MOE_HEADS:
        tag = f"{arch} (hd {hd}, {H} on {K} kv heads)"
        for dtype in (torch.float32, torch.bfloat16):
            for B, T, causal in ((1, 128, True), (2, 77, True), (1, 100, False)):
                q, k, v = grad_check.shifted_qkv(rng, T, T, dtype, B=B, H=H, K=K, hd=hd)
                check(f"flash {tag} {B},{T} causal={causal} {dtype}", flash_attention(q, k, v, causal=causal),
                      ref.mha_reference(q, k, v, causal=causal), TOL[dtype])
            q, pk, pv = grad_check.shifted_pages(rng, 3, H, K, hd, 12, 64, dtype)
            pt = torch.from_numpy(rng.integers(0, 12, size=(3, 4)).astype(np.int32)).cuda()
            lens = torch.tensor([1, 130, 256], dtype=torch.int32, device="cuda")
            check(f"paged {tag} 3,12 pages of 64, lengths 1/130/256 {dtype}",
                  paged_decode_attention(q, pk, pv, pt, lens), ref.paged_decode_reference(q, pk, pv, pt, lens),
                  TOL[dtype])
        out["flash_attention"][arch], out["paged_decode"][arch] = attention_serving_shapes(rng, arch, H, K, hd)
    return out


def phase_whisper_kernels(rng) -> dict:
    """Both attention kernels at whisper-small's shapes (hd 64, 12 query
    heads on 12 kv heads), new to the card with this slice, in fp32 and
    bf16: flash non-causal over the encoder's 1500 frames (T = S = 1500) and
    for cross-attention (T 128 against S 1500), and causal at the decoder's
    128-token prompt; paged decode over the 1500-slot cross cache (one page
    of 1500 slots, ``models.attention.identity_page_size``: no power of two
    divides 1500) at every length 0..1500 in bf16 and at its edges in fp32,
    and over the 256-slot self cache (pages of 64). Each timed in bf16
    beside its bound, its plain version and SDPA, and a CUDA-graph replay of
    the cross shapes. Every input is drawn by ``grad_check.shifted_qkv``:
    outputs O(1), so that the tolerance is ~3% of them, and a key past S
    that the kernel left unmasked would take a large share of the softmax
    (``grad_check --mutants`` reads that fault). Returns {kernel: {shape:
    numbers}}."""
    H, K, hd, S = 12, 12, 64, 1500
    tag = "whisper-small (hd 64, 12 on 12 kv heads)"
    for dtype in (torch.float32, torch.bfloat16):
        for T, Sk, causal in ((S, S, False), (128, S, False), (128, 128, True), (77, 300, False)):
            q, k, v = grad_check.shifted_qkv(rng, T, Sk, dtype)
            check(f"flash {tag} T {T} S {Sk} causal={causal} {dtype}", flash_attention(q, k, v, causal=causal),
                  ref.mha_reference(q, k, v, causal=causal), TOL[dtype])
        q, kc, vc = grad_check.shifted_qkv(rng, 1, 256, dtype)  # the decoder's self cache: pages of 64
        q, pk, pv = q.view(1, H, hd), kc.view(4, 64, K, hd), vc.view(4, 64, K, hd)
        pt = torch.arange(4, dtype=torch.int32, device="cuda").view(1, 4)
        for length in (1, 160, 256):
            lens = torch.tensor([length], dtype=torch.int32, device="cuda")
            check(f"paged {tag} self cache of 256, length {length} {dtype}", paged_decode_attention(q, pk, pv, pt, lens),
                  ref.paged_decode_reference(q, pk, pv, pt, lens), TOL[dtype])
    dt = torch.bfloat16
    flash = {}
    for name, T in (("encoder", S), ("cross", 128)):
        q, k, v = grad_check.shifted_qkv(rng, T, S, dt)
        err = check(f"flash {tag} {name} shape T {T} S {S}", flash_attention(q, k, v, causal=False),
                    ref.mha_reference(q, k, v, causal=False), TOL[dt])
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        flops, nbytes = cost.flash_attention(q, k, v, causal=False)  # every (query, key) pair
        bound_ms, by = bound(nbytes, flops, dt)
        print(f"  flash {tag} {name} shape, ms per call (sdpa = library yardstick), "
              f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
        t = timings(lambda: flash_attention(q, k, v, causal=False), lambda: ref.mha_reference(q, k, v, causal=False),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt), plain_iters=20)
        flash[name] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)
    graph_replay_matches("flash_attention at whisper's cross shape", lambda: flash_attention(q, k, v, causal=False))

    page = attention.identity_page_size(S)
    paged, errs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kc, vc = grad_check.shifted_qkv(rng, 1, S, dtype)
        q, pk, pv = q.view(1, H, hd), kc.view(S // page, page, K, hd), vc.view(S // page, page, K, hd)
        pt = torch.arange(S // page, dtype=torch.int32, device="cuda").view(1, -1)
        lengths = range(S + 1) if dtype == dt else (0, 1, 15, 16, 17, 127, 128, 129, 1024, 1499, 1500)
        err = 0.0
        for length in lengths:
            lens = torch.tensor([length], dtype=torch.int32, device="cuda")
            err = max(err, check(f"paged decode {tag} cross cache at length {length} {dtype}",
                                 paged_decode_attention(q, pk, pv, pt, lens),
                                 ref.paged_decode_reference(q, pk, pv, pt, lens), TOL[dtype], quiet=True))
        errs[dtype] = err
        print(f"  paged {tag} cross cache, one page of {page}, {len(lengths)} lengths in 0..{S} {dtype}: "
              f"max|d|={err:.3e} atol={TOL[dtype][0]:.0e} ok")
    lens = torch.tensor([S], dtype=torch.int32, device="cuda")
    graph_replay_matches("paged_decode_attention over whisper's cross cache",
                         lambda: paged_decode_attention(q, pk, pv, pt, lens))
    qs, ks, vs = q.view(1, H, 1, hd), kc.transpose(1, 2), vc.transpose(1, 2)
    flops, nbytes = cost.paged_decode(q, pk, pv, pt, lens)
    bound_ms, by = bound(nbytes, flops, dt)
    print(f"  paged {tag} over the full 1500-slot cross cache, ms per call (sdpa = library yardstick), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t = timings(lambda: paged_decode_attention(q, pk, pv, pt, lens),
                lambda: ref.paged_decode_reference(q, pk, pv, pt, lens),
                lambda: F.scaled_dot_product_attention(qs, ks, vs))
    paged["cross"] = dict(max_abs_err=errs[dt], max_abs_err_fp32=errs[torch.float32], bound_ms=bound_ms,
                          bound_by=by, **t)
    flash["decoder_self"], paged["self"] = attention_serving_shapes(rng, "whisper-small", H, K, hd)
    return {"flash_attention": flash, "paged_decode": paged}


def rglru_inputs(rng, B, T, W, dtype, long_memory=False):
    """λ in [0.5, 4] as the model's initialisation, where ∏a over a chunk of
    128 steps is 0 in fp32; with ``long_memory``, tests/test_torch_rglru.py's
    long memory: λ in [−4, −1], r ≤ 0.01 and x > 0, a within 0.025 of 1
    and ∏a over a chunk 0.2–0.9, as with trained weights."""
    x = randn(rng, (B, T, W), dtype)
    r, i = (torch.from_numpy(rng.uniform(size=(B, T, W)).astype(np.float32)).to("cuda", dtype) for _ in range(2))
    lam = torch.from_numpy(rng.uniform(*((-4.0, -1.0) if long_memory else (0.5, 4.0)),
                                       size=(W,)).astype(np.float32)).cuda()
    if long_memory:
        x, r = x.abs(), r * 0.01
    return x, r, i, lam


def check_rglru(name, x, r, i, lam, h0=None) -> float:
    y, h = rglru_scan(x, r, i, lam, h0)
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam, h0)
    return max(check(f"rglru y {name}", y, y_ref, TOL[x.dtype]),
               check(f"rglru h_last {name}", h, h_ref, TOL[torch.float32]))


def phase_rglru_kernel(rng) -> dict:
    """The RG-LRU kernel against its plain version (the sequential loop) over
    the tests/test_kernels.py grid and the chunked kernel's edges in fp32 and
    bf16, B 3 with a given h0, x/r/i as 16-byte aligned views cut to W 130,
    long memory at T 8192 and at B 3 with h0 (the look-back's folds seen),
    two eager calls and a CUDA-graph replay bit-equal in long memory, a
    carried h0 (two calls against one), then checked and timed at
    recurrentgemma-9b's serving shape in bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, W in RGLRU_GRID:
            check_rglru(f"{B},{T},{W} {dtype}", *rglru_inputs(rng, B, T, W, dtype))
        check_rglru(f"3,200,300 given h0 {dtype}", *rglru_inputs(rng, 3, 200, 300, dtype),
                    h0=randn(rng, (3, 300), torch.float32))
        xri = randn(rng, (2, 150, 3, 256), dtype)
        xri[:, :, 1:] = torch.sigmoid(xri[:, :, 1:])
        check_rglru(f"views of (2,150,3,256) cut to W 130 {dtype}", *(xri[:, :, k, :130] for k in range(3)),
                    torch.linspace(0.5, 4.0, 130, device="cuda"))
        for B, T, W, given in RGLRU_LONG:
            h0 = randn(rng, (B, W), torch.float32) if given else None
            check_rglru(f"long memory {B},{T},{W}{' given h0' if given else ''} {dtype}",
                        *rglru_inputs(rng, B, T, W, dtype, long_memory=True), h0=h0)
        x, r, i, lam = rglru_inputs(rng, 2, 2048, 1024, dtype, long_memory=True)
        h0 = randn(rng, (2, 1024), torch.float32)
        run = lambda: torch.cat([t.float().flatten() for t in rglru_scan(x, r, i, lam, h0)])  # noqa: E731
        if not torch.equal(run(), run()):
            raise AssertionError(f"rglru_scan {dtype}: two eager calls differ")
        graph_replay_matches(f"rglru_scan {dtype} (two eager calls bit-equal)", run)
    x, r, i, lam = rglru_inputs(rng, 1, 128, 128, torch.float32)
    y1, h1 = rglru_scan(x[:, :64], r[:, :64], i[:, :64], lam)
    y2, h2 = rglru_scan(x[:, 64:], r[:, 64:], i[:, 64:], lam, h1)
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam)
    check("rglru carried h0, y (two calls vs one)", torch.cat([y1, y2], 1), y_ref, (1e-5, 0.0))
    check("rglru carried h0, h_last", h2, h_ref, (1e-5, 0.0))

    dt = torch.bfloat16
    B, T, W = RGLRU_SERVING
    x, r, i, lam = rglru_inputs(rng, B, T, W, dt)
    err = check_rglru("serving shape", x, r, i, lam)
    # x, r, i read once, y written once (bf16); lam read and h_last written (fp32)
    flops, nbytes = cost.rglru_scan(x, r, i, lam)  # negligible FLOPs beside the bytes
    bound_ms, by = bound(nbytes, flops, torch.float32)
    print(f"  rglru serving shape, ms per call (no library call computes it), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP fp32 + {2 * B * T * W} exp, {B * T * W} sqrt):")
    t = timings(lambda: rglru_scan(x, r, i, lam), lambda: ref.rglru_reference(x, r, i, lam), plain_iters=2)
    results = {"rglru_scan": dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)}
    B, T, W = grad_check.RGLRU_TRAIN_SHAPE
    x, r, i, lam = rglru_inputs(rng, B, T, W, dt)
    err = check_rglru("training shape", x, r, i, lam)
    flops, nbytes = cost.rglru_scan(x, r, i, lam)
    bound_ms, by = bound(nbytes, flops, torch.float32)
    print(f"  rglru training shape (B {B}, T {T}, W {W}, bf16), ms per call (no library call computes it), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP fp32):")
    t = timings(lambda: rglru_scan(x, r, i, lam), lambda: ref.rglru_reference(x, r, i, lam), plain_iters=2)
    results["rglru_scan"]["training"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, **t)
    return results


# the MoE's row gathers at the benchmark cells' microbatches (qwen2-moe-a2.7b:
# E 60, top-4, d 2048, capacity factor 1.25, bf16): {name: N}
MOE_GATHER_SHAPES = {"train b4x512": 1024, "train b1x4096": 4096}
MOE_GATHER_SKEW = 16.0  # router scores + linspace(skew, 0) over the experts: 83-84% of slots dead, as in the cells


def check_equal(name, out, expect) -> float:
    """0.0 where the kernel's output has its plain version's bits; raises otherwise."""
    torch.cuda.synchronize()
    if out.dtype != expect.dtype or not torch.equal(out, expect):
        err = (out.float() - expect.float()).abs().max().item() if out.shape == expect.shape else float("inf")
        raise AssertionError(f"{name}: kernel not bit-equal to its plain version (max|d|={err})")
    print(f"  {name}: bit-equal")
    return 0.0


def moe_routing(rng, N, k, E, C, skew=MOE_GATHER_SKEW):
    """table, slots of ``moe.dispatch`` over a skewed router, on the card."""
    scores = torch.from_numpy(rng.normal(size=(N, E)).astype(np.float32)) + torch.linspace(skew, 0.0, E)
    top_p, top_i = torch.topk(torch.softmax(scores, -1), k, dim=-1)
    table, _, slots = moe.dispatch(top_i, top_p / top_p.sum(-1, keepdim=True), E, C)
    return table.cuda(), slots.cuda()


def phase_moe_gathers(rng) -> dict:
    """The MoE's two row-gather kernels (``csrc/moe_gather.cu``) against
    their plain versions, bit-equal, in fp32 and bf16 at qwen2-moe's and
    granite-moe's widths; then timed at the cells' microbatches in bf16 with
    83-84% of the slots dead: ``gather_rows`` (the dispatch, and the combine's
    backward), ``gather_sum_rows`` rounding after each add (the combine) and
    summing in fp32 (the dispatch's backward). Bound: the live rows read
    once, every output row written, the indices read. Library yardsticks:
    ``index_select`` over the rows with a zero row appended, and
    ``index_add_`` of the source rows into their tokens (atomics); beside
    them the ``index_put_`` accumulation that advanced indexing's backward
    ran before (``index_put_ ms``)."""
    for dtype in (torch.float32, torch.bfloat16):
        for N, k, E, d in ((2048, 4, 60, 2048), (2048, 8, 32, 1024), (300, 4, 60, 8)):
            C = moe.capacity(N, k, E, 1.25)
            table, slots = moe_routing(rng, N, k, E, C, skew=4.0)
            xt, ye = randn(rng, (N, d), dtype), randn(rng, (E * C, d), dtype)
            tag = f"N {N}, top-{k} of {E}, C {C}, d {d} {dtype}"
            for name, got, want in (
                    ("gather_rows", moe_gather.gather_rows(xt, table.view(-1)), ref.gather_rows_reference(xt, table.view(-1))),
                    ("gather_sum_rows", moe_gather.gather_sum_rows(ye, slots), ref.gather_sum_rows_reference(ye, slots)),
                    ("gather_sum_rows fp32 sum", moe_gather.gather_sum_rows(ye, slots, True),
                     ref.gather_sum_rows_reference(ye, slots, True))):
                check_equal(f"{name} {tag}", got, want)
    out = {"gather_rows": {"max_abs_err": 0.0}, "gather_sum_rows": {"max_abs_err": 0.0}}
    dt, k, E, d = torch.bfloat16, 4, 60, 2048
    for name, N in MOE_GATHER_SHAPES.items():
        C = moe.capacity(N, k, E, 1.25)
        table, slots = moe_routing(rng, N, k, E, C)
        idx = table.view(-1)
        xt, ye = randn(rng, (N, d), dt), randn(rng, (E * C, d), dt)
        xp = torch.cat([xt, xt.new_zeros(1, d)])
        live = idx < N
        live_rows, live_places = int(torch.unique(idx[live]).numel()), int(live.sum())
        print(f"  moe gathers, qwen2-moe-a2.7b {name}: N {N}, C {C}, E·C {E * C}, live slots {live_places} "
              f"({100 * live_places / (E * C):.1f}%), tokens read {live_rows}, tokens that lost every expert "
              f"{int((slots == E * C).all(1).sum())}")
        old = lambda: torch.zeros(N + 1, d, dtype=dt, device="cuda").index_put_((idx,), ye, accumulate=True)  # noqa: E731
        runs = (
            ("gather_rows", "", cost.gather_rows(xt, idx, live_rows),
             lambda: moe_gather.gather_rows(xt, idx), lambda: ref.gather_rows_reference(xt, idx),
             lambda: torch.index_select(xp, 0, idx)),
            ("gather_sum_rows", "", cost.gather_sum_rows(ye, slots, live_places),
             lambda: moe_gather.gather_sum_rows(ye, slots), lambda: ref.gather_sum_rows_reference(ye, slots),
             lambda: torch.zeros(N + 1, d, dtype=dt, device="cuda").index_add_(0, idx, ye)),
            ("gather_sum_rows", " backward", cost.gather_sum_rows(ye, slots, live_places),
             lambda: moe_gather.gather_sum_rows(ye, slots, True),
             lambda: ref.gather_sum_rows_reference(ye, slots, True),
             lambda: torch.zeros(N + 1, d, dtype=dt, device="cuda").index_add_(0, idx, ye)))
        for kernel, part, (flops, nbytes), fn, plain, library in runs:
            err = check_equal(f"{kernel}{part} {name}", fn(), plain())
            bound_ms, by = bound(nbytes, flops, torch.float32)
            print(f"  {kernel}{part} {name}, ms per call (library: index_select / index_add_), "
                  f"bound {bound_ms:.5f} ms ({by}: {nbytes} B):")
            t = timings(fn, plain, library)
            if TIMED and part:
                t["index_put_ms"] = eager_ms(old, 10, 2)  # device-bound: tens of ms a call
                print(f"  advanced indexing's backward (index_put_ accumulate) {t['index_put_ms']:.4f} ms")
            out[kernel][name + part] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by, live_rows=live_rows,
                                            **t)
    return out


def ssd_inputs(rng, b, t, h, p, n, dtype):
    x = randn(rng, (b, t, h, p), dtype)
    dA = -randn(rng, (b, t, h), torch.float32).abs() * 0.3
    return x, dA, randn(rng, (b, t, 1, n), dtype), randn(rng, (b, t, 1, n), dtype)


def check_ssd(name, x, dA, B_, C_, chunk) -> tuple[float, float]:
    """Both SSD kernels against their plain versions (each on the same
    inputs: ssd_output is fed the plain y_diag and H_in), and the chunked
    path they make against the sequential oracle. Returns the max|Δ| of
    (ssd_states, ssd_output)."""
    f32 = SSD_TOL[torch.float32]
    y_diag, S = ssd_states(x, dA, B_, C_, chunk)
    yd_ref, S_ref = ref.ssd_states_reference(x, dA, B_, C_, chunk)
    e_states = max(check(f"ssd_states y_diag {name}", y_diag, yd_ref, f32),
                   check(f"ssd_states S {name}", S, S_ref, f32))
    H_in, _ = inter_chunk_scan(S_ref, dA, chunk)
    e_output = check(f"ssd_output {name}", ssd_output(yd_ref, dA, C_, H_in, x.dtype),
                     ref.ssd_output_reference(yd_ref, dA, C_, H_in, x.dtype), SSD_TOL[x.dtype])
    y, H_last = ssd_chunked_cuda(x, dA, B_, C_, chunk)
    y_ref, H_ref = ref.ssd_chunk_reference(x, dA, B_, C_)
    check(f"ssd chunked vs sequential oracle, y {name}", y, y_ref, SSD_TOL[x.dtype])
    check(f"ssd chunked vs sequential oracle, state {name}", H_last, H_ref, f32)
    return e_states, e_output


def phase_ssd_kernels(rng) -> dict:
    cases = [(dtype, case) for dtype in (torch.float32, torch.bfloat16) for case in SSD_GRID]
    cases += [(torch.bfloat16, case) for case in SSD_EDGES] + [(torch.float32, SSD_SERVING)]
    for dtype, (b, t, h, p, n, chunk) in cases:
        check_ssd(f"{b},{t},{h},{p},{n},{chunk} {dtype}", *ssd_inputs(rng, b, t, h, p, n, dtype), chunk)
    for dtype in (torch.float32, torch.bfloat16):
        x, dA, B_, C_ = ssd_inputs(rng, 1, 300, 4, 64, 128, dtype)
        graph_replay_matches(f"ssd_chunked_cuda {dtype}",
                             lambda: torch.cat([a.float().flatten() for a in ssd_chunked_cuda(x, dA, B_, C_, 256)]))
    # the serving shape of mamba2-1.3b and one microbatch of its phase-6b
    # step, in bf16, checked and timed
    serving, training = time_ssd(rng, "serving", SSD_SERVING), time_ssd(rng, "training", grad_check.SSD_TRAIN_SHAPE)
    return {k: {**serving[k], "training": training[k]} for k in serving}


def time_ssd(rng, label: str, shape) -> dict:
    """Both SSD kernels checked and timed in bf16 at ``shape``: {kernel: numbers}."""
    dt = torch.bfloat16
    b, t, h, p, n, cs = shape
    x, dA, B_, C_ = ssd_inputs(rng, b, t, h, p, n, dt)
    e_states, e_output = check_ssd(f"{label} shape", x, dA, B_, C_, cs)
    results = {}
    # C·Bᵀ once per (batch, chunk): it does not depend on the head when g = 1;
    # at the bf16 rate, the type the kernel multiplies in
    flops, nbytes = cost.ssd_states(x, dA, B_, C_, cs)
    bound_ms, by = bound(nbytes, flops, dt)
    print(f"  ssd_states {label} shape {shape}, ms per call (no library call computes it), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t_ = timings(lambda: ssd_states(x, dA, B_, C_, cs), lambda: ref.ssd_states_reference(x, dA, B_, C_, cs))
    results["ssd_states"] = dict(max_abs_err=e_states, bound_ms=bound_ms, bound_by=by, **t_)
    y_diag, S = ref.ssd_states_reference(x, dA, B_, C_, cs)
    H_in, _ = inter_chunk_scan(S, dA, cs)
    flops, nbytes = cost.ssd_output(x, dA, C_, cs)
    bound_ms, by = bound(nbytes, flops, dt)  # the bf16 kernel multiplies bf16 terms of H_in
    print(f"  ssd_output {label} shape {shape}, ms per call (no library call computes it), "
          f"bound {bound_ms:.5f} ms ({by}: {nbytes} B, {flops} FLOP):")
    t_ = timings(lambda: ssd_output(y_diag, dA, C_, H_in, dt), lambda: ref.ssd_output_reference(y_diag, dA, C_, H_in, dt))
    results["ssd_output"] = dict(max_abs_err=e_output, bound_ms=bound_ms, bound_by=by, **t_)
    return results


def encoder_layers(cfg) -> str:
    return f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers else ""


def model_inputs(cfg, rng) -> dict:
    """Prefill's inputs beside the prompt: an audio model's seeded frame
    embeddings over all ``enc_len`` positions (CPU, fp32)."""
    if cfg.family != "audio":
        return {}
    return {"enc_embeds": torch.from_numpy(rng.normal(size=(1, cfg.enc_len, cfg.d_model)).astype(np.float32))}


def phase_parity(arch: str, prompt_len: int, n_layers: int = 2) -> None:
    """Teacher-forced logits, card (kernels) against CPU (plain path), fp32.

    Tolerance PARITY_ATOL on logits of magnitude ~4: both sides compute in
    fp32 (TF32 off) and differ only in summation order (~1e-5), except that
    a cache is bf16 on both (qwen3's KV cache, mamba2's conv tails,
    recurrentgemma's conv tails and ring K/V); a last-ulp fp32 difference can
    round a cached element to the neighbouring bf16 value (2^-8 relative),
    which moves a logit by far less than 1e-3. mamba2's SSD and
    recurrentgemma's RG-LRU run in fp32 throughout on the card and, in an
    fp32 model, on the CPU too. The weights are drawn on the card (faster
    than on the CPU at recurrentgemma's 8.4 GB of fp32 embeddings) and
    copied to the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cut(arch, n_layers, dtype="float32")
    t0 = time.perf_counter()
    gpu = build_model(cfg, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cpu = build_model(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, prompt_len))).long()
    feed = torch.from_numpy(rng.integers(0, cfg.vocab, size=(4, 1, 1))).long()
    frames = model_inputs(cfg, rng)
    errs, agree = [], []
    with torch.no_grad():
        lc, cc = cpu.prefill(prompt, **frames, pad_to=prompt_len + 192)
        lg, cg = gpu.prefill(prompt.cuda(), **{k: v.cuda() for k, v in frames.items()}, pad_to=prompt_len + 192)
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
    print(f"[4 model parity] {arch} full width, {n_layers} layers{encoder_layers(cfg)}, fp32, "
          f"prefill {prompt_len} + 4 decode: "
          f"max|d| per step {['%.2e' % e for e in errs]} tol={PARITY_ATOL:.0e}, "
          f"argmax agree {agree}, {time.perf_counter() - t0:.1f} s")
    if max(errs) > PARITY_ATOL or not all(agree):
        raise AssertionError(f"{arch}: card and CPU logits differ by {max(errs)}, argmax agree {agree}")
    del cpu, gpu, cc, cg
    torch.cuda.empty_cache()


def phase_bf16_record(arch: str, prompt_len: int, n_layers: int = 2, steps: int = 8) -> None:
    """The bf16 path that serves (bf16 weights and activations, as
    ``launch/serve.py`` builds it), card (kernels) against CPU (plain path),
    recorded and not gated (ROADMAP Queue C 11): one set of seeded weights
    drawn on the card, depth cut as in ``phase_parity``, the prompt
    prefilled, then ``steps`` greedy decode steps on each side, each fed its
    own argmax. Prints the logits' max|Δ| over the prefill and the steps
    before the tokens first differ, and that first step (None: never). Fails
    only on logits that are not finite or of the wrong shape."""
    cfg = cut(arch, n_layers)
    t0 = time.perf_counter()
    gpu = build_model(cfg, "cuda", param_dtype=torch.bfloat16).init(torch.Generator(device="cuda").manual_seed(0))
    cpu = build_model(cfg, "cpu", param_dtype=torch.bfloat16)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, prompt_len))).long()
    frames = model_inputs(cfg, rng)
    err, diverged = 0.0, None
    with torch.no_grad():
        lc, cc = cpu.prefill(prompt, **frames, pad_to=prompt_len + 192)
        lg, cg = gpu.prefill(prompt.cuda(), **{k: v.cuda() for k, v in frames.items()}, pad_to=prompt_len + 192)
        for step in range(steps + 1):
            lg = lg.cpu()
            if not torch.isfinite(lg).all() or lg.shape != (1, cfg.padded_vocab):
                raise AssertionError(f"{arch} bf16: bad logits at step {step}, shape {tuple(lg.shape)}")
            if diverged is None:
                err = max(err, (lc.float() - lg.float())[:, : cfg.vocab].abs().max().item())
            tc, tg = int(lc[:, : cfg.vocab].argmax()), int(lg[:, : cfg.vocab].argmax())
            if diverged is None and tc != tg:
                diverged = step
            if step < steps:
                lc, cc = cpu.decode_step(cc, torch.tensor([[tc]]))
                lg, cg = gpu.decode_step(cg, torch.tensor([[tg]], device="cuda"))
    print(f"[4 bf16 record] {arch} full width, {n_layers} layers{encoder_layers(cfg)}, bf16, prefill {prompt_len} + "
          f"{steps} greedy "
          f"decode steps: logits max|d| {err:.3e} before the tokens differ, first differing step {diverged} "
          f"(0 = the prefill's token), {time.perf_counter() - t0:.1f} s")
    del cpu, gpu, cc, cg
    torch.cuda.empty_cache()


# the cache holds 256 slots, identity pages of 64: the paged-decode shape
# that phase 3's serving checks hold at both models' heads, every length
MESH_PROMPT, MESH_STEPS, MESH_CACHE = 64, 8, 256
EXPLICIT_PATHS = {"V9 row_parallel_einsum": transformer.row_parallel_einsum,
                  "V3 sharded_decode_update_attend": attention.sharded_decode_update_attend,
                  "V2 moe_ffn_local": moe.moe_ffn_local}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_greedy(model, prompt, mesh, flags) -> tuple[list, torch.Tensor]:
    """Prefill and ``MESH_STEPS`` greedy decode steps, bf16: without a mesh,
    or under ``mesh`` and ``flags`` with the KV cache placed on it by the
    model's ``cache_axes``. Returns (tokens, logits of every step)."""
    ctx = contextlib.ExitStack()
    if mesh is not None:
        ctx.enter_context(rdist.mesh_context(mesh))
        ctx.enter_context(perf_context(flags))
    tokens, logits = [], []
    with ctx, torch.no_grad():
        lg, cache = model.prefill(prompt, pad_to=MESH_CACHE)
        if mesh is not None:
            cache = rdist.distribute_tree(cache, mesh, model.cache_axes())
            if not rdist.is_dtensor(cache["k"]):
                raise AssertionError("the KV cache was not placed on the mesh")
        for step in range(MESH_STEPS + 1):
            if not torch.isfinite(lg).all() or lg.shape != (1, model.cfg.padded_vocab):
                raise AssertionError(f"bad logits at step {step}: shape {tuple(lg.shape)}")
            tok = int(lg[:, : model.cfg.vocab].argmax())
            tokens.append(tok)
            logits.append(lg.float().cpu())
            if step < MESH_STEPS:
                lg, cache = model.decode_step(cache, torch.tensor([[tok]], device="cuda"))
    return tokens, torch.cat(logits)


def phase_mesh(smi: str) -> None:
    """Phase ``mesh``: the distribution layer on the card. A 1-rank NCCL
    process group (with gloo beside it for CPU tensors) and a (1, 1)
    ``DeviceMesh`` ("data", "model"); under it, with every ``PerfConfig``
    flag on, qwen3-4b and granite-moe-1b-a400m at full width cut to 2
    layers, bf16 as served: prefill 64 + 8 greedy decode steps with the KV
    cache (``MESH_CACHE`` slots) placed on the mesh, whose tokens must equal
    the same run's without a mesh. At one rank V3 takes its dense path on the placed cache and V2
    routes the whole batch as its one data shard, as the reference's do,
    while V9's reduce-scatter and all-gather run through NCCL; each explicit
    path's calls are counted against the layers that make them. Then
    ``compressed_psum`` over a qwen3-4b layer's gradient shapes on CUDA
    tensors through NCCL, bit-equal to the same call on the CPU through
    gloo. Raises on any mismatch."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    dist.init_process_group("cuda:nccl,cpu:gloo", rank=0, world_size=1)
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), "cuda")
        flags = PerfConfig(**{f.name: True for f in dataclasses.fields(PerfConfig)})
        rng = np.random.default_rng(0)
        for arch in ("qwen3-4b", "granite-moe-1b-a400m"):
            cfg = cut(arch, 2)
            model = build_model(cfg, "cuda", param_dtype=torch.bfloat16).init(
                torch.Generator(device="cuda").manual_seed(0))
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, MESH_PROMPT))).long().cuda()
            want, want_logits = mesh_greedy(model, prompt, None, flags)
            for fn in EXPLICIT_PATHS.values():
                fn.mesh_calls = 0
            got, logits = mesh_greedy(model, prompt, mesh, flags)
            calls = {name: fn.mesh_calls for name, fn in EXPLICIT_PATHS.items()}
            L = cfg.n_layers
            expect = {"V9 row_parallel_einsum": L + (0 if cfg.family == "moe" else L * (1 + MESH_STEPS)),
                      "V3 sharded_decode_update_attend": L * MESH_STEPS,
                      "V2 moe_ffn_local": L * (1 + MESH_STEPS) if cfg.family == "moe" else 0}
            err = (logits - want_logits)[:, : cfg.vocab].abs().max().item()
            print(f"[mesh] {arch} full width, {L} layers, bf16, (1, 1) mesh over NCCL, every PerfConfig flag on: "
                  f"prefill {MESH_PROMPT} + {MESH_STEPS} greedy steps over {MESH_CACHE} cache slots, tokens {got} "
                  f"{'equal' if got == want else 'DIFFER from'} the run without a mesh, logits max|d| {err:.3e}, "
                  f"explicit-path calls {calls} (expected {expect}) [{smi}]")
            if got != want or calls != expect:
                raise AssertionError(f"{arch} under the mesh: tokens {got} vs {want}, calls {calls} vs {expect}")
            del model
            torch.cuda.empty_cache()
        cfg = get_config("qwen3-4b")
        d, ff, qd, kd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.resolved_head_dim, \
            cfg.n_kv_heads * cfg.resolved_head_dim
        shapes = {"wq": (d, qd), "wk": (d, kd), "wv": (d, kd), "wo": (qd, d), "w_gate": (d, ff), "w_up": (d, ff),
                  "w_down": (ff, d), "ln1": (d,), "ln2": (d,), "q_norm": (cfg.resolved_head_dim,)}
        g = torch.Generator(device="cuda").manual_seed(1)
        grads = {k: torch.randn(s, generator=g, device="cuda") * 1e-3 for k, s in shapes.items()}
        grads["ln1"][: 2 * compression.BLOCK] = 0.0  # all-zero blocks
        err = {k: torch.randn(s, generator=g, device="cuda") * 1e-6 for k, s in shapes.items()}
        t1 = time.perf_counter()
        total, new_err = compression.compressed_psum(grads, err, mesh.get_group("data"))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        total_h, err_h = compression.compressed_psum({k: v.cpu() for k, v in grads.items()},
                                                     {k: v.cpu() for k, v in err.items()}, dist.group.WORLD)
        differ = [k for k in shapes if not (torch.equal(total[k].cpu(), total_h[k])
                                            and torch.equal(new_err[k].cpu(), err_h[k]))]
        n = sum(v.numel() for v in grads.values())
        worst = max((total_h[k] + err_h[k] - grads[k].cpu() - err[k].cpu()).abs().max().item() for k in shapes)
        print(f"[mesh] compressed_psum over a qwen3-4b layer's gradient shapes ({n} elements), CUDA tensors "
              f"through NCCL against CPU tensors through gloo: {'bit-equal' if not differ else f'DIFFER at {differ}'}"
              f", sum + carried error vs the input max|d| {worst:.3e}, {card_s:.3f} s on the card; phase "
              f"{time.perf_counter() - t0:.1f} s")
        if differ:
            raise AssertionError(f"compressed_psum: card and CPU differ at {differ}")
        # the elastic restore: a 1-layer qwen3-4b train state saved into the
        # port's engine on disk, loaded onto the NCCL mesh
        cfg, opt = cut("qwen3-4b", 1), OptimizerConfig()
        model = build_model(cfg, "cuda")
        state = init_state(model, torch.Generator(device="cuda").manual_seed(2), opt)
        store = BVCheckpointStore(str(fresh_dir("mesh")))
        store.save(1, state)
        t1 = time.perf_counter()
        loaded, meta = store.load_distributed(mesh, state, state_axes(model, opt, state))
        load_s = time.perf_counter() - t1
        saved, got = leaves_with_paths(state), dict(leaves_with_paths(loaded))
        differ = [p for p, t in saved if not (rdist.is_dtensor(got[p]) and got[p].device.type == "cuda"
                                              and torch.equal(got[p].full_tensor().cpu(), t.detach().cpu()))]
        print(f"[mesh] load_distributed: a qwen3-4b train state at full width, 1 layer ({len(saved)} leaves, "
              f"{store.stats()['user_bytes']} B into the engine at {store.db.path}), saved at step {meta['step']} "
              f"and placed on "
              f"the (1, 1) NCCL mesh by its state axes in {load_s:.3f} s: every leaf a CUDA DTensor equal to what "
              f"was saved: {not differ}")
        store.close()
        shutil.rmtree(store.db.path)
        if differ or set(got) != {p for p, _ in saved}:
            raise AssertionError(f"load_distributed: leaves differ from what was saved: {differ}")
        del model, state, loaded, store
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


MESH_TRAIN_STEPS = 3
# fp32, of a leaf's largest |value|: the bound on the leaves whose sums may
# run in another order under the mesh (the tied embedding and its moments)
# and on the metrics; a missing or wrong update exceeds it by orders
MESH_TRAIN_RTOL = 1e-6


def tied(name: str) -> bool:
    """The tied embedding and its optimizer moments, or a step's metric."""
    return name.endswith("['embed']") or name.startswith("step ")


def state_bits(trainer) -> dict:
    """A copy of every leaf of a trainer's state, gathered where placed."""
    return {p: (x.full_tensor() if rdist.is_dtensor(x) else x.detach().clone()) for p, x in
            leaves_with_paths(trainer.state)}


def compare_runs(got: dict, want: dict) -> dict:
    """Per-step loss and grad norm, and every leaf: whether the bits are
    equal, else the largest |Δ|. ``within_tol``: every leaf bit-equal but
    the tied embedding and its moments, and those and the metrics within
    ``MESH_TRAIN_RTOL`` of their largest |value|."""
    pairs = {f"step {a['step']} {k}": (torch.tensor(a[k]), torch.tensor(b[k]))
             for a, b in zip(got["metrics"], want["metrics"]) for k in ("loss", "grad_norm")}
    pairs.update({p: (got["state"][p].float(), want["state"][p].float()) for p in want["state"]})
    differ = [name for name, (a, b) in pairs.items() if not torch.equal(a, b)]
    diff = {name: (a - b).abs().max().item() for name, (a, b) in pairs.items()}
    same_keys = got["state"].keys() == want["state"].keys() and len(got["metrics"]) == len(want["metrics"])
    return {"bit_equal": not differ and same_keys, "differ": differ, "compared": len(pairs),
            "max_abs_diff": max(diff.values()), "worst": max(diff, key=diff.get),
            "within_tol": same_keys and all(tied(n) and diff[n] <= MESH_TRAIN_RTOL * pairs[n][1].abs().max().item()
                                            for n in differ)}


def mesh_train_check() -> int:
    """Phase ``mesh``'s training legs, in their own process (``chip_smoke.py
    --mesh-train-check``, with CUBLAS_WORKSPACE_CONFIG set before cuBLAS
    starts, deterministic algorithms): a 1-rank NCCL group and a (1, 1) mesh,
    every ``PerfConfig`` flag on. qwen3-4b and granite-moe-1b-a400m at full
    width cut to 2 layers, fp32 masters, bf16 compute, AdamW, remat, 3 steps
    of 4 × 512 in 2 microbatches: ``Trainer(mesh=...)`` against the same
    trainer without a mesh from the same seed, the kernels' launches and the
    explicit paths' calls of the mesh run counted; then, for
    granite-moe-1b-a400m, a mesh run of 2 steps saving into the port's
    engine on disk and a fresh ``Trainer(mesh=...)`` that restores it and
    takes step 3. Prints one JSON line; exits non-zero on a failed check."""
    import torch.distributed as dist

    from repro_torch.training.trainer import TrainerConfig

    t_start = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    dist.init_process_group("cuda:nccl,cpu:gloo", rank=0, world_size=1)
    out, ok = {}, True
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), "cuda")
        flags = PerfConfig(**{f.name: True for f in dataclasses.fields(PerfConfig)})
        for arch in ("qwen3-4b", "granite-moe-1b-a400m"):
            cfg = cut(arch, 2)

            def run(steps, on_mesh, ckpt=None):
                tcfg = TrainerConfig(steps=steps, global_batch=TRAIN_B, seq_len=TRAIN_T, ckpt_dir=ckpt,
                                     ckpt_interval=100, ckpt_async=False, log_every=1000, train=TRAIN_CFG)
                t0 = time.perf_counter()
                with perf_context(flags):
                    trainer = Trainer(cfg, tcfg, mesh=mesh if on_mesh else None)
                    res = trainer.run()
                torch.cuda.synchronize()
                run = {"metrics": [{k: m[k] for k in ("step", "loss", "grad_norm")} for m in res["metrics"]],
                       "state": state_bits(trainer), "seconds": time.perf_counter() - t0,
                       "restore_s": trainer.restore_seconds}
                if ckpt is not None:
                    run["save_s"] = sum(sec for _, sec in trainer.ckpt.save_times)
                    run["engine"] = trainer.store.stats()["user_bytes"]
                trainer.close()
                del trainer
                torch.cuda.empty_cache()
                return run

            plain = run(MESH_TRAIN_STEPS, False)
            for fn in WRAPPERS.values():
                fn.launches = 0
            for fn in EXPLICIT_PATHS.values():
                fn.mesh_calls = 0
            transformer.row_parallel_einsum.backward_calls = 0
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # the run without a mesh's state, kept to compare
            meshed = run(MESH_TRAIN_STEPS, True)
            L, A, steps = cfg.n_layers, TRAIN_CFG.accum_steps, MESH_TRAIN_STEPS
            row_parallel = L * (1 if cfg.family == "moe" else 2)  # wo, and w_down outside the MoE FFN
            calls = {"flash_attention": flash_attention.launches,
                     **{k: fn.launches for k, fn in WRAPPERS.items() if k != "flash_attention"},
                     "V9 forward": transformer.row_parallel_einsum.mesh_calls,
                     "V9 backward": transformer.row_parallel_einsum.backward_calls,
                     "V2": moe.moe_ffn_local.mesh_calls}
            expect = {k: 0 for k in WRAPPERS}
            expect.update({k: n * steps for k, n in cost.train_step_launches(cfg, A, TRAIN_CFG.remat).items()})
            expect.update({"V9 forward": row_parallel * 2 * A * steps,
                           "V9 backward": row_parallel * A * steps,
                           "V2": L * 2 * A * steps if cfg.family == "moe" else 0})
            cmp = compare_runs(meshed, plain)
            entry = {"layers": L, "calls": calls, "expect": calls == expect, "expected": expect, **cmp,
                     "losses": [m["loss"] for m in meshed["metrics"]],
                     "grad_norms": [m["grad_norm"] for m in meshed["metrics"]],
                     "plain_losses": [m["loss"] for m in plain["metrics"]],
                     "seconds": {"plain": plain["seconds"], "mesh": meshed["seconds"]},
                     "peak_allocated": torch.cuda.max_memory_allocated() - held}
            ok &= calls == expect and cmp["within_tol"]
            if cfg.family == "moe":
                path = fresh_dir("mesh_train")
                del plain
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                first = run(MESH_TRAIN_STEPS - 1, True, str(path))
                resumed = run(MESH_TRAIN_STEPS, True, str(path))
                state_bytes = sum(t.numel() * t.element_size() for t in first["state"].values())
                resume = compare_runs({"metrics": resumed["metrics"], "state": resumed["state"]},
                                      {"metrics": meshed["metrics"][-1:], "state": meshed["state"]})
                entry["resume"] = {**resume, "steps": [m["step"] for m in resumed["metrics"]],
                                   "save_s": first["save_s"], "state_bytes": state_bytes,
                                   "user_bytes": first["engine"], "restore_s": resumed["restore_s"],
                                   "peak_allocated": torch.cuda.max_memory_allocated() - held}
                ok &= resume["bit_equal"] and entry["resume"]["steps"] == [MESH_TRAIN_STEPS]
                shutil.rmtree(path)
            out[arch] = entry
    finally:
        dist.destroy_process_group()
    out["bytes_written"], out["seconds"] = bytes_written(), time.perf_counter() - t_start
    print("MESHTRAIN " + json.dumps(out))
    return 0 if ok else 1


def phase_mesh_train(smi: str) -> dict:
    """Runs :func:`mesh_train_check` in a child process and prints its
    readings; returns the mesh runs' kernel launches by path."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--mesh-train-check"], capture_output=True,
                         text=True, env=env, timeout=900)
    line = next((ln for ln in res.stdout.splitlines() if ln.startswith("MESHTRAIN ")), None)
    out = json.loads(line[len("MESHTRAIN "):]) if line else {}
    paths = {}
    for arch in ("qwen3-4b", "granite-moe-1b-a400m"):
        if arch not in out:
            continue
        e = out[arch]
        print(f"[mesh train] {arch} full width, {e['layers']} layers, fp32 masters, bf16 compute, AdamW, remat, "
              f"{MESH_TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_T} in {TRAIN_CFG.accum_steps} microbatches, every "
              f"PerfConfig flag on, deterministic algorithms: Trainer(mesh=(1, 1) over NCCL) against the trainer "
              f"without a mesh from the same seed: losses {e['losses']} (without: {e['plain_losses']}), grad norms "
              f"{e['grad_norms']}, losses, grad norms and state after step {MESH_TRAIN_STEPS} "
              f"{'bit-equal' if e['bit_equal'] else 'DIFFER'} (max|d| {e['max_abs_diff']:.3e} at {e['worst']}, "
              f"{len(e['differ'])} of {e['compared']} metrics and leaves not bit-equal: {e['differ']}; "
              f"bit-equal but the tied embedding, its moments and the metrics, those within {MESH_TRAIN_RTOL} "
              f"of their largest |value|: {e['within_tol']}); launches and explicit-path calls "
              f"{e['calls']} "
              f"(expected {e['expected']}); {e['seconds']['mesh']:.1f} s under the mesh, "
              f"{e['seconds']['plain']:.1f} s without, peak allocated by the mesh run {e['peak_allocated']} B "
              f"[{smi}]")
        paths[f"{arch} mesh training"] = {k: v for k, v in e["calls"].items() if k in WRAPPERS and v}
        if "resume" in e:
            r = e["resume"]
            print(f"[mesh train] {arch}: saved at step {MESH_TRAIN_STEPS - 1} under the mesh into the port's engine "
                  f"on disk ({r['state_bytes']} B of state, {r['user_bytes']} B into the engine) in {r['save_s']:.3f}"
                  f" s ({r['state_bytes'] / r['save_s'] / 1e9:.3f} GB/s); a fresh Trainer(mesh=...) restored it in "
                  f"{r['restore_s']:.3f} s and took step(s) {r['steps']}: "
                  f"{'bit-equal' if r['bit_equal'] else 'DIFFER'} to the uninterrupted run's step "
                  f"{MESH_TRAIN_STEPS} (max|d| {r['max_abs_diff']:.3e}); peak allocated by the two runs "
                  f"{r['peak_allocated']} B "
                  f"[{smi}]")
    if out:
        print(f"[mesh train] the child process: {out['seconds']:.1f} s, {out['bytes_written']} B written")
    if res.returncode != 0 or set(paths) != {"qwen3-4b mesh training", "granite-moe-1b-a400m mesh training"}:
        raise AssertionError(f"mesh train check failed (rc {res.returncode}): {res.stdout[-2000:]} "
                             f"{res.stderr[-3000:]}")
    return paths


def serve_path(arch: str, prompt_len: int, max_len: int) -> dict:
    """Serve 8 requests of ``arch`` at full width and depth in bf16, with
    every launch count set to 0 just before; check that each kernel ran once
    per layer of its kind per prefill or decode call
    (``cost.launches_per_call``) and the others not at all. Returns the
    counts of the path's kernels."""
    cfg = get_config(arch)
    n_req, max_new = 8, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = serve.build(cfg, "cuda")
    for fn in WRAPPERS.values():
        fn.launches = 0
    engine, m = serve.run(model, requests=n_req, prompt_len=prompt_len, max_new=max_new, max_batch=4,
                          max_len=max_len)
    launches = {k: fn.launches for k, fn in WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"[5 serve] {arch} {cfg.n_layers} layers d_model {cfg.d_model} bf16, prompt {prompt_len}, "
          f"max_len {max_len}: requests {m['requests']}, "
          f"tokens {m['tokens']}, {m['tokens_per_s']:.2f} tok/s over {m['wall_s']:.3f} s, "
          f"mean TTFT {m['mean_ttft_s'] * 1e3:.2f} ms, mean latency {m['mean_latency_s'] * 1e3:.2f} ms, "
          f"peak memory {peak / 2**30:.3f} GiB, prefill calls {m['prefill_calls']}, "
          f"decode calls {m['decode_calls']}, launches {launches}")
    if m["requests"] != n_req or any(len(r.tokens) != max_new for r in engine.finished):
        raise AssertionError("not every request got its tokens")
    if not all(0 <= t < cfg.vocab for r in engine.finished for t in r.tokens):
        raise AssertionError("a token id outside the vocabulary")
    if m["prefill_calls"] != n_req or m["decode_calls"] == 0:
        raise AssertionError(f"prefill calls {m['prefill_calls']}, decode calls {m['decode_calls']}")
    per_call = cost.launches_per_call(cfg)
    expect = {k: 0 for k in WRAPPERS}
    expect.update({k: pre * m["prefill_calls"] + dec * m["decode_calls"] for k, (pre, dec) in per_call.items()})
    if launches != expect:
        raise AssertionError(f"{arch}: launches {launches} != layers of each kind x calls {expect}")
    if peak >= MEMORY_LIMIT:
        raise AssertionError(f"{arch}: peak memory {peak} B is not under {MEMORY_LIMIT} B")
    del model, engine
    return {k: launches[k] for k in per_call}


def phase_serve() -> dict:
    """{arch: {kernel: launches}} of each path's serving run."""
    return {arch: serve_path(arch, prompt_len, max_len)
            for arch, prompt_len, max_len in (("qwen3-4b", 128, 256), ("mamba2-1.3b", 1024, 1280),
                                              ("recurrentgemma-9b", 2048, 2112),
                                              ("granite-moe-1b-a400m", 128, 256), ("qwen2-moe-a2.7b", 128, 256),
                                              ("whisper-small", 128, 256))}


def phase_grad_check(dtype: str, arch: str = "qwen3-4b", n_layers: int = 2, gated: bool = True) -> dict:
    """Gradients of ``arch`` at full width, ``n_layers`` layers, fp32
    masters, compute in ``dtype``, one TokenPipeline batch (B 2, T 512): the
    card (the flash kernel forward, ``ops.Attention``'s backward; the SSD
    kernels' forward, ``ops.SSDScan``'s backward; the RG-LRU kernel's
    forward, ``ops.RGLRU``'s backward; remat; a MoE model's row gathers
    through ``ops.MoEDispatch`` / ``MoECombine``, the rest of its FFN in torch
    ops) against the CPU (the jnp-body ports under autograd), weights drawn
    on the card and copied to the CPU (``launch/grad_check.py``). Gated at
    ``grad_check.GRAD_RTOL``, every leaf's gradient nonzero on both sides (a
    MoE model's router included); with ``gated`` False, recorded only."""
    t0 = time.perf_counter()
    r = grad_check.run(dtype, arch, n_layers)
    tol, ok = grad_check.GRAD_RTOL[dtype], grad_check.passes(r, dtype)
    verdict = ("ok" if ok else "FAIL") if gated else "recorded, not gated"
    print(f"[6a gradient check] {arch} full width, {n_layers} layers, fp32 masters, {dtype} compute, B 2 T 512: "
          f"loss card {r['loss_card']:.6f} cpu {r['loss_cpu']:.6f} |d| {r['loss_abs_err']:.3e}, worst leaf "
          f"{r['worst_leaf']} max|dg|/max|g| {r['worst_rel_err']:.3e}, leaves with a zero gradient {r['zero']}, "
          f"tol {tol:.0e} {verdict}, {time.perf_counter() - t0:.1f} s")
    if gated and not ok:
        raise AssertionError(f"gradient check {arch} {dtype}: {r}")
    torch.cuda.empty_cache()
    return r


# phase 6b's runs, (arch, layers): full depth (None) but recurrentgemma-9b's
# 38 layers and qwen2-moe-a2.7b's 24, which need ~167 and ~229 GB of train
# state (``launch/dryrun.py --one-rank-step 4 512 2``: 9 and 6 layers fit)
TRAIN_RUNS = (("qwen3-4b", None), ("mamba2-1.3b", None), ("recurrentgemma-9b", 9), ("granite-moe-1b-a400m", None),
              ("whisper-small", None), ("qwen2-moe-a2.7b", 6))
TRAIN_STEPS = 4


def train_config(arch: str, n_layers: int | None):
    return get_config(arch) if n_layers is None else cut(arch, n_layers)


def phase_train_full(smi: str, arch: str, n_layers: int | None) -> tuple:
    """``arch`` at full width, cut to ``n_layers`` (None: its full depth),
    fp32 masters, bf16 compute, AdamW, remat, global batch 4 × 512 in 2
    microbatches (with the pipeline's inputs beside the tokens, as the
    trainer's: whisper's 1500 frame embeddings a row), 4 steps, the caching
    allocator's segments growing in place as the training entry sets them
    (``launch/train.py::train_allocator``), every launch count set to 0 just
    before: each kernel launched exactly ``cost.train_step_launches`` × 4
    times and no other kernel; finite losses, peak allocated and reserved
    memory under ``MEMORY_LIMIT``. Returns the path's launches, and what
    phase ``dryrun`` holds its prediction against: the bytes allocated by
    ``init_state``, the peak allocated, the mean step ms, and one more step
    counted as the dry run counts (``FlopCounterMode`` and the kernels'
    tally)."""
    with train.train_allocator("cuda"):
        cfg = train_config(arch, n_layers)
        B, T, A, steps = TRAIN_B, TRAIN_T, TRAIN_CFG.accum_steps, TRAIN_STEPS
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        before = torch.cuda.memory_allocated()
        model = build_model(cfg, "cuda")
        state = init_state(model, torch.Generator(device="cuda").manual_seed(0), TRAIN_CFG.opt)
        state_bytes = torch.cuda.memory_allocated() - before
        n_params = sum(p.numel() for p in model.parameters())
        step_fn = make_train_step(model, TRAIN_CFG)
        pipe = TokenPipeline(cfg.vocab, B, T, seed=0, extra_fields=extra_fields(cfg))
        batches = [{k: torch.from_numpy(v).cuda() for k, v in pipe.next_batch().items()} for _ in range(steps)]
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for fn in WRAPPERS.values():
            fn.launches = 0
        losses, ms = [], []
        for batch in batches:
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(metrics["loss"]))
        launches = {k: fn.launches for k, fn in WRAPPERS.items()}
        peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        step_ms = sum(ms[1:]) / len(ms[1:])
        print(f"[6b train] {arch} {cfg.n_layers} layers{encoder_layers(cfg)} d_model {cfg.d_model}, {n_params} "
              f"parameters, fp32 masters, bf16 compute, AdamW, remat, global batch {B} x {T} in {A} microbatches: "
              f"losses {losses}, grad_norm {float(metrics['grad_norm']):.4f}, step ms {['%.1f' % t for t in ms]}, "
              f"steps 2-{steps} {step_ms:.1f} ms, {B * T / step_ms * 1e3:.1f} training tokens/s, state "
              f"{state_bytes / 1e9:.2f} GB, peak allocated {peak / 1e9:.2f} GB, reserved {reserved / 1e9:.2f} GB "
              f"(limit {MEMORY_LIMIT / 1e9:.0f} GB), set-up {setup_s:.1f} s, launches {launches} [{smi}]")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{arch}: a training loss is not finite: {losses}")
        per_step = cost.train_step_launches(cfg, A, TRAIN_CFG.remat)
        expect = {k: per_step.get(k, 0) * steps for k in WRAPPERS}
        if launches != expect:
            raise AssertionError(f"{arch}: training launches {launches} != {expect}")
        if max(peak, reserved) >= MEMORY_LIMIT:
            raise AssertionError(f"{arch}: peak memory {max(peak, reserved)} B is not under {MEMORY_LIMIT} B")
        # one more step, counted as the dry run counts (not part of the launch check above)
        counted = dryrun.count_step(lambda: step_fn(state, batches[0]))
        torch.cuda.synchronize()
        del model, state, step_fn, batches, counted["out"]
        torch.cuda.empty_cache()
        return ({k: launches[k] for k in per_step},
                {"state_bytes": state_bytes, "peak_allocated": peak, "peak_reserved": reserved, "step_ms": step_ms,
                 "flops": counted["flops"], "aten_flops": counted["aten_flops"],
                 "kernel_flops": counted["kernel_flops"], "kernel_calls": counted["kernel_calls"]})


def one_rank_records() -> dict:
    """Phase 6b's runs predicted on the meta device (in :func:`cpu_checks`):
    {arch: the ``launch.dryrun`` record of its step on one rank at 6b's
    shape (global batch 4 × 512, accumulation 2, remat, AdamW), its memory,
    FLOPs and roofline; and "meta": the whole step counted as phase 6b
    counts its extra step (``FlopCounterMode`` and the kernels' tally)}."""
    cell = ShapeCell("phase6b", TRAIN_T, TRAIN_B, "train")
    out = {}
    for arch, n_layers in TRAIN_RUNS:
        rec = dryrun.run_cell(arch, cell.name, mesh=MeshLayout((1, 1), ("data", "model")), cell=cell,
                              train_cfg=TRAIN_CFG, quiet=True, n_layers=n_layers)
        cfg = train_config(arch, n_layers)
        model = build_model(cfg, "meta")
        state = init_state(model, None, TRAIN_CFG.opt)
        batch, _ = specs.batch_specs(cfg, cell)
        meta = dryrun.count_step(lambda: make_train_step(model, TRAIN_CFG)(state, batch))
        out[arch] = {"memory": {k: v for k, v in rec["memory"].items() if k != "temp_bytes_basis"},
                     "flops_per_device": rec["cost"]["flops_per_device"], "roofline": rec["roofline"],
                     "meta": {k: meta[k] for k in ("flops", "aten_flops", "kernel_flops", "kernel_calls")}}
    return out


def phase_dryrun(smi: str, card: dict, checks: dict) -> None:
    """Phase ``dryrun``: (1) the records of ``repro_torch.launch.dryrun`` over
    every arch × shape on both production layouts (baseline variant), which
    :func:`cpu_checks` wrote on the meta device (no JAX on this machine):
    every cell ``ok``, or ``skip`` with the config's own reason, none
    ``error``; the counts, the seconds and the roofline table of pod16x16
    printed. (2) Each phase-6b run's record on one rank
    (:func:`one_rank_records`, also from :func:`cpu_checks`), held against
    the card's run (``card``: {arch: :func:`phase_train_full`'s numbers}):
    the argument bytes within ``ARGS_RTOL`` of what ``init_state``
    allocated, and the FLOPs of one step, meta against card, equal (and the
    record's microstep × 2 equal to both), gated; the predicted total per
    device and its 80 GB fit beside the card's peak, and the step's FLOPs
    over its ms as a share of the bf16 peak (``train_mfu``), recorded."""
    import importlib.util

    rc, seconds = checks["dryrun"]["rc"], checks["dryrun"]["seconds"]
    recs = [json.loads(f.read_text()) for f in sorted(DRYRUN_DIR.glob("*.json"))]
    counts = {st: sum(r["status"] == st for r in recs) for st in ("ok", "skip", "error")}
    wrong_skips = [(r["arch"], r["shape"]) for r in recs if r["status"] == "skip"
                   and r["reason"] != get_config(r["arch"]).shape_supported(SHAPES[r["shape"]])[1]]
    spec = importlib.util.spec_from_file_location("roofline", Path(__file__).resolve().parent / "benchmarks" /
                                                  "roofline.py")
    roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline)
    print(f"[dryrun] every arch x shape on pod16x16 and pod2x16x16 over meta tensors: {len(recs)} cells "
          f"(expected {2 * len(ARCH_IDS) * len(SHAPES)}), {counts}, {seconds:.1f} s in the child process beside "
          f"the card phases; roofline of pod16x16 (benchmarks/roofline.py):")
    print(roofline.render(recs, "pod16x16"))
    if rc != 0 or counts["error"] or wrong_skips or len(recs) != 2 * len(ARCH_IDS) * len(SHAPES):
        raise AssertionError(f"dry run: rc {rc}, {counts}, skips without the config's reason {wrong_skips}")

    bad = []
    for arch, n_layers in TRAIN_RUNS:
        rec, c = checks["one_rank"][arch], card[arch]
        mem, meta = rec["memory"], rec["meta"]
        args = mem["argument_bytes"]
        args_err = abs(args - c["state_bytes"]) / c["state_bytes"]
        flops_equal = meta["flops"] == c["flops"] == rec["flops_per_device"]
        mfu = c["flops"] / (c["step_ms"] / 1e3) / H100["peak_flops_bf16"]
        layers = f"{train_config(arch, n_layers).n_layers} layers"
        print(f"[dryrun] {arch} {layers} at phase 6b's shape (4 x 512, accumulation 2, remat, AdamW) on one rank, "
              f"predicted against the card [{smi}]: argument bytes {args} vs {c['state_bytes']} allocated by "
              f"init_state (|d| {args_err:.3e}, gate {ARGS_RTOL}); FLOPs of one step: meta {meta['flops']} (aten "
              f"{meta['aten_flops']}, kernels {meta['kernel_flops']}, calls {meta['kernel_calls']}), card "
              f"{c['flops']} (aten {c['aten_flops']}, kernels {c['kernel_flops']}, calls {c['kernel_calls']}), "
              f"record {rec['flops_per_device']:.0f} ({'equal' if flops_equal else 'DIFFER'}); memory: predicted "
              f"total {mem['total_per_device']} B (argument {args} + temp {mem['temp_bytes']} + output "
              f"{mem['output_bytes']} - alias {mem['alias_bytes']}; fits {mem['device_bytes'] / 1e9:.0f} GB: "
              f"{mem['fits']}) over 6b's peak allocated {c['peak_allocated']} B = "
              f"{mem['total_per_device'] / c['peak_allocated']:.4f} (reserved {c['peak_reserved']} B; not gated); "
              f"train_mfu {mfu:.4f} ({c['flops']} FLOP in {c['step_ms']:.1f} ms over "
              f"{H100['peak_flops_bf16']:.3g} FLOP/s bf16); roofline {rec['roofline']}")
        if args_err > ARGS_RTOL or not flops_equal:
            bad.append((arch, args_err, meta["flops"], c["flops"], rec["flops_per_device"]))
    if bad:
        raise AssertionError(f"dry run against the card (arch, argument bytes |d|, FLOPs meta, card, record): {bad}")


CKPT_ROOT = Path(__file__).resolve().parent / "build" / "ckpt"


def fresh_dir(name: str) -> Path:
    """An empty directory for an engine, under the checkout's ``build/``."""
    path = CKPT_ROOT / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def filesystem(path: Path) -> dict:
    """The mount that holds ``path`` (the longest mount point of
    /proc/mounts above it): its device, filesystem type and free bytes."""
    path = os.path.realpath(path)
    best = ("", "?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best[0]):
                best = (mnt, dev, fstype)
    st = os.statvfs(path)
    return {"mount": best[0], "device": best[1], "fstype": best[2], "free_bytes": st.f_bavail * st.f_frsize}


ENGINE_KEYS = ("user_bytes", "wal_bytes", "bvalue_bytes", "flush_bytes", "compaction_bytes", "write_amp")


def bytes_written() -> int:
    """The bytes this process has passed to write calls so far (``wchar`` of
    /proc/self/io: files, deleted ones too, and its pipes). A run should
    stay under 45 GiB of writes; phases 6c and 6d each report theirs."""
    with open("/proc/self/io") as f:
        return next(int(line.split()[1]) for line in f if line.startswith("wchar:"))


def resume_check() -> int:
    """Phase 6c, in its own process (``chip_smoke.py --resume-check``, with
    CUBLAS_WORKSPACE_CONFIG set before cuBLAS starts): the trainer of
    ``launch/train.py`` on qwen3-4b at full width and 1 layer under
    deterministic algorithms, checkpointing into the port's engine on disk:
    4 steps straight against 2, then a new trainer that re-opens the second
    directory and resumes for 2 more. Prints one JSON line; exits non-zero
    unless every leaf is bit-equal and the re-opened engine's scrub is
    clean."""
    torch.use_deterministic_algorithms(True)
    cfg = cut("qwen3-4b", 1)
    t0 = time.perf_counter()

    def trainer_run(path, steps, scrub=False):
        tcfg = train.build(steps=steps, batch=2, seq=512, ckpt_dir=str(path), ckpt_interval=100)
        trainer, res = train.run(cfg, tcfg)
        out = {p: t.detach().cpu() for p, t in leaves_with_paths(trainer.state)}
        stats = trainer.store.stats()
        run = {"save_s": sum(sec for _, sec in trainer.ckpt.save_times), "stall_s": trainer.ckpt.stall_seconds,
               "saves": trainer.ckpt.save_count, "steps_kept": trainer.store.steps(),
               "restore_s": trainer.restore_seconds,
               "engine": {k: stats[k] for k in ENGINE_KEYS}}
        if scrub:
            run["scrub"] = trainer.store.db.verify_integrity()
        trainer.close()
        return res, out, run

    full_dir, dir_ = fresh_dir("6c_straight"), fresh_dir("6c_resumed")
    fs = filesystem(dir_)
    full, full_state, full_run = trainer_run(full_dir, 4)
    half, _, half_run = trainer_run(dir_, 2)
    resumed, resumed_state, resumed_run = trainer_run(dir_, 4, scrub=True)
    differ = [p for p in full_state if not torch.equal(full_state[p], resumed_state[p])]
    losses = [m["loss"] for m in full["metrics"]]
    scrub = resumed_run.pop("scrub")
    state_bytes = sum(t.numel() * t.element_size() for t in full_state.values())
    out = {"resume_bit_equal": not differ and full_state.keys() == resumed_state.keys(), "differ": differ,
           "losses": losses, "resumed_losses": [m["loss"] for m in half["metrics"] + resumed["metrics"]],
           "resumed_steps": [m["step"] for m in resumed["metrics"]], "leaves": len(full_state),
           "state_bytes": state_bytes, "filesystem": fs,
           "scrub": {k: scrub[k] for k in ("sst_files", "blocks_verified", "values_verified", "findings")},
           "straight": full_run, "first_2": half_run,
           "resumed_2": resumed_run, "seconds": time.perf_counter() - t0}
    for path in (full_dir, dir_):
        shutil.rmtree(path)
    out["bytes_written"] = bytes_written()
    print("RESUME " + json.dumps(out))
    ok = (out["resume_bit_equal"] and out["resumed_steps"] == [3, 4] and all(np.isfinite(losses))
          and not scrub["findings"] and scrub["values_verified"] > 0)
    return 0 if ok else 1


def phase_resume(smi: str) -> dict:
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--resume-check"], capture_output=True,
                         text=True, env=env, timeout=900)
    line = next((ln for ln in res.stdout.splitlines() if ln.startswith("RESUME ")), None)
    out = json.loads(line[len("RESUME "):]) if line else {}
    print(f"[6c resume] qwen3-4b full width, 1 layer, batch 2 x 512, deterministic algorithms, checkpoints in the "
          f"port's BVLSM engine on disk: 4 steps straight vs 2 + a new trainer re-opening the directory for 2: "
          f"{json.dumps(out)}")
    if out:
        fs, first = out["filesystem"], out["first_2"]
        print(f"[6c resume] {fs['fstype']} ({fs['device']} on {fs['mount']}, {fs['free_bytes']} B free): "
              f"{out['state_bytes']} B of state per save; the first trainer's save at step 2: "
              f"{first['save_s']:.3f} s saving ({out['state_bytes'] / first['save_s'] / 1e9:.3f} GB/s), "
              f"{first['stall_s']:.3f} s stalled, engine {first['engine']}; the resumed trainer read it back in "
              f"{out['resumed_2']['restore_s']:.3f} s and saved step 4 in {out['resumed_2']['save_s']:.3f} s, "
              f"engine {out['resumed_2']['engine']} [{smi}]")
    if res.returncode != 0 or not out.get("resume_bit_equal"):
        raise AssertionError(f"resume check failed (rc {res.returncode}): {res.stderr[-3000:]}")
    return out


# phase 6d's harness runs: 54–75 s together on the card machine's 9p disk,
# in the child process of :func:`cpu_checks`
DIFF_EXAMPLES, CRASH_ITERS, FAILOVER_ITERS = 40, 40, 24
DRYRUN_DIR = _build.BUILD_DIR / "dryrun"


def cpu_checks() -> int:
    """The work of phases dryrun and 6d that needs no card, in a child
    process (``chip_smoke.py --cpu-checks``, no CUDA device visible) that
    :func:`main` starts after phase 3 and joins before phase dryrun, so that
    it runs beside the card phases: (1) ``repro_torch.launch.dryrun --all
    --both-meshes`` on the meta device, its records written under
    ``build/dryrun`` for phase dryrun to check, then phase 6b's runs on one
    rank (:func:`one_rank_records`); (2) the port's harnesses on the
    checkout's disk under ``build/ckpt``: ``model_db`` on one engine and
    on 3 shards, ``crash_harness`` and ``failover_harness`` in sync and
    async WAL modes. Prints one JSON line; exits non-zero if the dry run
    failed or a harness found a divergence or a violation."""
    from repro_torch.testing import crash_harness, failover_harness, model_db

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    out = {}
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
        rc = dryrun.main(["--all", "--both-meshes", "--out", str(DRYRUN_DIR)])
    out["dryrun"] = {"rc": rc, "seconds": time.perf_counter() - t0}
    t1 = time.perf_counter()
    out["one_rank"] = one_rank_records()
    out["one_rank_s"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    harness_dir = fresh_dir("6d_harness")  # the harnesses make their directories with mkdtemp
    tempfile.tempdir = str(harness_dir)
    out["filesystem"] = filesystem(harness_dir)
    runs = {}
    for shards in (0, 3):
        rep = model_db.run_differential(examples=DIFF_EXAMPLES, seed=0, shards=shards)
        runs[f"model_db shards {shards}"] = {"examples": rep["examples"], "divergences": len(rep["failures"]),
                                             "seconds": rep["seconds"]}
    rep = crash_harness.run_crash_loop(CRASH_ITERS, seed=0, wal_modes=("sync", "async"))
    runs["crash_harness sync+async"] = {"iterations": rep["iterations"], "violations": len(rep["failures"]),
                                        "crashed_mid_workload": rep["crashed_mid_workload"],
                                        "seconds": rep["seconds"]}
    rep = failover_harness.run_failover_loop(FAILOVER_ITERS, seed=0, wal_modes=("sync", "async"))
    runs["failover_harness sync+async"] = {"iterations": rep["iterations"], "violations": len(rep["failures"]),
                                           "failures": [str(f)[:400] for f in rep["failures"]],
                                           "scenarios": rep["scenarios"], "seconds": rep["seconds"]}
    tempfile.tempdir = None
    shutil.rmtree(harness_dir)
    out["harnesses"], out["harness_s"] = runs, time.perf_counter() - t1
    out["harnesses_ok"] = all(r.get("divergences", 0) == 0 and r.get("violations", 0) == 0 for r in runs.values())
    out["seconds"] = time.perf_counter() - t0
    print("CPUCHECKS " + json.dumps(out))
    return 0 if rc == 0 and out["harnesses_ok"] else 1


CPU_CHECKS_LOG = _build.BUILD_DIR / "cpu_checks"  # .out and .err: files, so that no pipe fills up


def start_cpu_checks() -> subprocess.Popen:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    CPU_CHECKS_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{CPU_CHECKS_LOG}.out", "w") as out, open(f"{CPU_CHECKS_LOG}.err", "w") as err:
        return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--cpu-checks"], stdout=out,
                                stderr=err, env=env)


def join_cpu_checks(proc: subprocess.Popen) -> dict:
    """Waits for :func:`cpu_checks` and returns its JSON line."""
    proc.wait(timeout=900)
    stdout = Path(f"{CPU_CHECKS_LOG}.out").read_text()
    line = next((ln for ln in stdout.splitlines() if ln.startswith("CPUCHECKS ")), None)
    if line is None:
        err = Path(f"{CPU_CHECKS_LOG}.err").read_text()
        raise AssertionError(f"the CPU checks failed (rc {proc.returncode}): {err[-3000:]}")
    return json.loads(line[len("CPUCHECKS "):])


class CountingTransport(InProcessTransport):
    """The in-process transport, counting the frames it sends (the engine
    counts groups and bytes shipped; a group longer than
    ``repl_batch_bytes`` goes as several frames)."""

    def __init__(self, env, stream):
        super().__init__(env, stream)
        self.frames = 0

    def send(self, wire):
        self.frames += 1
        super().send(wire)


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def leaf_bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def bit_equal(saved: dict, state) -> list:
    """The leaves of ``state`` whose bytes differ from ``saved``'s CPU copy."""
    got = dict(leaves_with_paths(state))
    if got.keys() != saved.keys():
        return sorted(set(got) ^ set(saved))
    return [p for p, t in saved.items() if got[p].dtype != t.dtype or not torch.equal(leaf_bits(got[p]), leaf_bits(t))]


def restore(cfg, tcfg, db) -> tuple[Trainer, int]:
    """A new trainer over ``db`` that reads the latest checkpoint into its
    state (the restore half of ``Trainer.run``, without its final save: a
    second 5.88 GB write would not fit the call's budget)."""
    trainer = Trainer(cfg, tcfg, db)
    return trainer, trainer._init_or_restore()


def storage_check() -> int:
    """Phase 6d's card legs, in their own process (``chip_smoke.py
    --storage-check``; (a), the harnesses, ran in :func:`cpu_checks`): (b) the
    trainer of ``launch/train.py`` (qwen3-4b, full width, 1 layer)
    checkpointing into a 4-shard ``ShardedDB`` on the store's own engine
    config, and a new trainer restoring from the re-opened router; (c) the
    same trainer checkpointing into a primary ``DB`` with a replica attached,
    the primary crashed once the replica caught up, the replica promoted and
    a new trainer restoring from it. Prints one JSON line; exits non-zero
    unless every leaf came back bit-equal with clean scrubs."""
    t0 = time.perf_counter()
    out, ok = {}, True

    cfg = cut("qwen3-4b", 1)
    tcfg = train.build(steps=2, batch=2, seq=512, ckpt_interval=100)

    def saved_copy(trainer):
        return {p: t.detach().cpu().clone() for p, t in leaves_with_paths(trainer.state)}

    # (b) a 4-shard router
    t1 = time.perf_counter()
    sharded_dir = fresh_dir("6d_sharded")
    trainer, res = train.run(cfg, tcfg, ShardedDB.open(str(sharded_dir), shards=4, config=store_config()))
    saved = saved_copy(trainer)
    state_bytes = sum(t.numel() * t.element_size() for t in saved.values())
    stats = trainer.store.stats()
    b = {"steps": [m["step"] for m in res["metrics"]], "losses": [m["loss"] for m in res["metrics"]],
         "saves": trainer.ckpt.save_count, "save_s": sum(sec for _, sec in trainer.ckpt.save_times),
         "stall_s": trainer.ckpt.stall_seconds, "state_bytes": state_bytes, "shards": stats["shards"],
         "engine": {k: stats["aggregate"][k] for k in ENGINE_KEYS},
         "bvalue_bytes_per_shard": [sh["bvalue_bytes"] for sh in stats["per_shard"]], "router": stats["router"]}
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    trainer, step = restore(cfg, tcfg, ShardedDB.open(str(sharded_dir), config=store_config()))
    b["restored_step"], b["restore_s"] = step, trainer.restore_seconds
    b["differ"] = bit_equal(saved, trainer.state)
    scrub = trainer.store.db.verify_integrity()
    b["scrub"] = {"sst_files": scrub["sst_files"], "values_verified": scrub["values_verified"],
                  "values_per_shard": [r["values_verified"] for r in scrub["per_shard"]],
                  "findings": scrub["findings"]}
    trainer.close()
    del trainer, saved
    torch.cuda.empty_cache()
    shutil.rmtree(sharded_dir)
    b["seconds"] = time.perf_counter() - t1
    out["sharded"] = b
    ok &= (b["restored_step"] == 2 and not b["differ"] and not b["scrub"]["findings"] and b["saves"] == 1
           and all(n > 0 for n in b["bvalue_bytes_per_shard"]) and all(n > 0 for n in b["scrub"]["values_per_shard"])
           and all(np.isfinite(b["losses"])))

    # (c) failover: a primary and a replica on the store's config, the replica on its own directory
    t1 = time.perf_counter()
    primary_dir, replica_dir = fresh_dir("6d_primary"), fresh_dir("6d_replica")
    primary = DB.open(str(primary_dir), store_config())
    replica = bootstrap_replica(primary, str(replica_dir), cfg=store_config())
    mirrored_before = dir_bytes(replica_dir / "bvalue")
    transport = CountingTransport(primary.env, f"repl://{replica_dir}")
    link = attach(primary, replica, transport=transport)
    trainer, res = train.run(cfg, tcfg, primary)
    t_saved = time.perf_counter()
    caught_up = link.wait_caught_up(timeout=600)
    c = {"steps": [m["step"] for m in res["metrics"]], "save_s": sum(sec for _, sec in trainer.ckpt.save_times),
         "stall_s": trainer.ckpt.stall_seconds, "caught_up": caught_up,
         "catch_up_s": time.perf_counter() - t_saved}
    saved = saved_copy(trainer)
    pstats = primary.stats()
    c["primary_engine"] = {k: pstats[k] for k in ENGINE_KEYS}
    c["repl_bytes_shipped"], c["repl_batches_shipped"] = pstats["repl_bytes_shipped"], pstats["repl_batches_shipped"]
    c["frames"] = transport.frames
    # the machine of the primary dies: its close skips the memtable flush and the
    # trainer's clean close, which follows, finds the engine closed already
    primary.close(crash=True)
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    status = replica.replication_status()
    c["status_before_promote"] = status
    t2 = time.perf_counter()
    replica.promote()
    c["promote_s"] = time.perf_counter() - t2
    rstats = replica.stats()
    c["replica_counters"] = {k: rstats[k] for k in ("repl_batches_applied", "repl_catchups", "repl_crc_checks",
                                                    "repl_frames_corrupt", "repl_frames_duplicate",
                                                    "repl_value_fetch_misses", "repl_divergence_detected",
                                                    "promotions")}
    # the engine keeps no counter of the values a follower mirrors: its
    # BValue files grow by them
    c["mirrored_value_bytes"] = dir_bytes(replica_dir / "bvalue") - mirrored_before
    c["role_after"] = replica.replication_status()["role"]
    trainer, step = restore(cfg, tcfg, replica)
    c["restored_step"], c["restore_s"] = step, trainer.restore_seconds
    c["differ"] = bit_equal(saved, trainer.state)
    scrub = replica.verify_integrity()
    c["scrub"] = {k: scrub[k] for k in ("sst_files", "blocks_verified", "values_verified", "findings")}
    trainer.close()
    del trainer, saved
    torch.cuda.empty_cache()
    shutil.rmtree(primary_dir)
    shutil.rmtree(replica_dir)
    c["seconds"] = time.perf_counter() - t1
    out["failover"] = c
    ok &= (caught_up and status.get("lag") == 0 and not status.get("diverged") and c["restored_step"] == 2
           and not c["differ"] and not c["scrub"]["findings"] and c["scrub"]["values_verified"] > 0
           and c["role_after"] == "primary" and c["mirrored_value_bytes"] >= state_bytes)
    out["seconds"] = time.perf_counter() - t0
    out["bytes_written"] = bytes_written()
    out["ok"] = bool(ok)
    print("STORAGE " + json.dumps(out))
    return 0 if ok else 1


def phase_storage(smi: str, resume: dict, checks: dict) -> dict:
    """Phase 6d: the harnesses' results from :func:`cpu_checks`, then the card
    legs in a child process (:func:`storage_check`); prints their numbers and
    the bytes phases 6c and 6d wrote."""
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--storage-check"], capture_output=True,
                         text=True, timeout=900)
    line = next((ln for ln in res.stdout.splitlines() if ln.startswith("STORAGE ")), None)
    out = json.loads(line[len("STORAGE "):]) if line else {}
    print(f"[6d storage] the port's harnesses, then qwen3-4b full width, 1 layer, batch 2 x 512, 2 steps, "
          f"checkpointed into a 4-shard ShardedDB and into a primary DB with a replica: {json.dumps(out)}")
    fs = checks["filesystem"]
    print(f"[6d storage] (a) in the child process beside the card phases, on {fs['fstype']} ({fs['device']} on "
          f"{fs['mount']}): " + "; ".join(f"{name} {json.dumps(r)}" for name, r in checks["harnesses"].items())
          + f"; {checks['harness_s']:.1f} s")
    if out.get("sharded") and out.get("failover"):
        b, c = out["sharded"], out["failover"]
        print(f"[6d storage] (b) ShardedDB, 4 shards: {b['state_bytes']} B saved in {b['save_s']:.3f} s "
              f"({b['state_bytes'] / b['save_s'] / 1e9:.3f} GB/s), {b['stall_s']:.3f} s stalled, restored in "
              f"{b['restore_s']:.3f} s, {len(b['differ'])} leaves differ; engine {b['engine']}; BValue bytes "
              f"per shard {b['bvalue_bytes_per_shard']}; scrub {b['scrub']} [{smi}]")
        print(f"[6d storage] (c) failover: saved in {c['save_s']:.3f} s "
              f"({b['state_bytes'] / c['save_s'] / 1e9:.3f} GB/s), replica caught up {c['catch_up_s']:.3f} s "
              f"after the save returned, lag {c['status_before_promote'].get('lag')} before the promote, "
              f"promoted in {c['promote_s']:.3f} s, restored in {c['restore_s']:.3f} s, {len(c['differ'])} "
              f"leaves differ; shipped {c['repl_bytes_shipped']} B in {c['frames']} frames "
              f"({c['repl_batches_shipped']} groups), mirrored {c['mirrored_value_bytes']} B of values; "
              f"scrub {c['scrub']} [{smi}]")
    total = resume.get("bytes_written", 0) + out.get("bytes_written", 0)
    print(f"[6d storage] bytes written: 6c {resume.get('bytes_written')}, 6d {out.get('bytes_written')}, "
          f"6c + 6d {total} ({total / 2**30:.2f} GiB of the call's 45); 6d in {out.get('seconds', 0):.1f} s")
    if res.returncode != 0 or not out.get("ok") or not checks["harnesses_ok"]:
        raise AssertionError(f"storage check failed (rc {res.returncode}, harnesses clean: "
                             f"{checks['harnesses_ok']}): {res.stderr[-3000:]}")
    return out


def attention_readings() -> list:
    """Phase 3's attention checks, recorded: [(check, max|Δ|/tol, max|Δ|)]."""
    global RECORD
    RECORD = []
    try:
        phase_attention_kernels(np.random.default_rng(0))
        return RECORD
    finally:
        RECORD = None


def mutants_main() -> int:
    """``chip_smoke.py --mutants``: phase 3's attention checks on the kernels
    as built and on every planted fault (``grad_check.MUTANTS`` in the bf16
    flash kernel, ``grad_check.PAGED_MUTANTS`` in paged decode), each built
    into a library of its own. Prints, per kernel, the checks it fails and
    its largest max|Δ|/tol, and writes the checks each passes to
    ``build/mutants.json``; exits non-zero unless the kernels as built pass
    every check and every mutant fails at least one."""
    global TIMED
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _, smi = phase_device()
    phase_build()
    TIMED = False
    t0 = time.perf_counter()
    libs = {kernel: grad_check.build_mutants(kernel) for kernel in ("flash_attention", "paged_decode")}
    print(f"[mutants] built {sum(map(len, libs.values()))} mutants in {time.perf_counter() - t0:.1f} s")
    rows, ok = [], True
    runs = [("as built", None, None)] + [(name, kernel, lib) for kernel, muts in libs.items()
                                          for name, lib in muts.items()]
    for name, kernel, lib in runs:
        built = _build.library(kernel) if kernel else None
        if kernel:
            grad_check.use(lib, kernel)
        try:
            rec = attention_readings()
        finally:
            if kernel:
                grad_check.use(built, kernel)
        fails = [r for r in rec if r[1] > 1.0]
        worst = max(rec, key=lambda r: r[1])
        row = {"mutant": name, "kernel": kernel, "checks": len(rec), "failed": len(fails),
               "max_ratio": worst[1], "max_abs_err": worst[2], "at": worst[0],
               "failed_dtypes": sorted({"bf16" if "bfloat16" in r[0] or "torch" not in r[0] else "fp32"
                                        for r in fails}),
               "passed_checks": [r[0] for r in rec if r[1] <= 1.0] if kernel else []}
        rows.append(row)
        ok &= (len(fails) == 0) if kernel is None else (len(fails) > 0)
        print(f"[mutant] {name} ({kernel or 'both kernels'}): fails {len(fails)} of {len(rec)} checks, "
              f"max|d|/tol {worst[1]:.4g} (max|d| {worst[2]:.4g}) at {worst[0]} [{smi}]", flush=True)
    out = _build.BUILD_DIR / "mutants.json"
    out.write_text(json.dumps(rows, indent=1))
    print(f"[mutants] every check's name, per mutant, in {out}")
    print(json.dumps({"mutants": [{k: v for k, v in r.items() if k != "passed_checks"} for r in rows]}))
    return 0 if ok else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    marks = {}  # seconds since the start at the end of each phase
    name, smi = phase_device()
    phase_build()
    marks["build"] = time.perf_counter() - t_start
    results = phase_kernels()
    marks["kernels"] = time.perf_counter() - t_start
    cpu = start_cpu_checks()
    try:
        return run_phases(name, smi, t_start, marks, results, cpu)
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()


def run_phases(name, smi, t_start, marks, results, cpu) -> int:
    """:func:`main` after phase 3, with the CPU checks' process running."""
    phase_parity("qwen3-4b", 64)
    phase_parity("mamba2-1.3b", 512)
    phase_parity("recurrentgemma-9b", 2048, n_layers=3)
    phase_parity("granite-moe-1b-a400m", 64)
    phase_parity("qwen2-moe-a2.7b", 64)
    phase_parity("whisper-small", 64)
    phase_bf16_record("qwen3-4b", 64)
    phase_bf16_record("mamba2-1.3b", 512)
    phase_bf16_record("recurrentgemma-9b", 2048, n_layers=3)
    phase_bf16_record("granite-moe-1b-a400m", 64)
    phase_bf16_record("qwen2-moe-a2.7b", 64)
    phase_bf16_record("whisper-small", 64)
    marks["parity"] = time.perf_counter() - t_start
    phase_mesh(smi)
    marks["mesh"] = time.perf_counter() - t_start
    mesh_paths = phase_mesh_train(smi)
    marks["mesh train"] = time.perf_counter() - t_start
    by_path = phase_serve()
    marks["serve"] = time.perf_counter() - t_start
    phase_grad_check("float32")
    phase_grad_check("bfloat16")
    for arch in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "whisper-small"):
        phase_grad_check("float32", arch)
    for arch, n_layers in (("mamba2-1.3b", 2), ("recurrentgemma-9b", 3)):
        phase_grad_check("float32", arch, n_layers)
    # ROADMAP Queue C 11, recorded (recurrentgemma-9b's: launch/grad_check.py --arch recurrentgemma-9b --layers 3)
    phase_grad_check("bfloat16", "mamba2-1.3b", gated=False)
    marks["6a"] = time.perf_counter() - t_start
    train_numbers = {}
    for arch, n_layers in TRAIN_RUNS:
        by_path[f"{arch} training"], train_numbers[arch] = phase_train_full(smi, arch, n_layers)
    marks["6b"] = time.perf_counter() - t_start
    t_join = time.perf_counter()
    checks = join_cpu_checks(cpu)
    print(f"[cpu checks] the child process beside the card phases: {checks['seconds']:.1f} s (dry run "
          f"{checks['dryrun']['seconds']:.1f} s, phase 6b's runs on one rank {checks['one_rank_s']:.1f} s, "
          f"harnesses {checks['harness_s']:.1f} s); waited "
          f"{time.perf_counter() - t_join:.1f} s for it")
    phase_dryrun(smi, train_numbers, checks)
    marks["dryrun"] = time.perf_counter() - t_start
    resume = phase_resume(smi)
    marks["6c"] = time.perf_counter() - t_start
    phase_storage(smi, resume, checks)
    marks["6d"] = time.perf_counter() - t_start
    by_path.update(mesh_paths)
    # a kernel's launches: those of the first path that runs it, whose shapes
    # its top-level times are taken at; every path's count beside them, and
    # the times at another path's shapes (head_dim 256, the MoE heads, the
    # training shapes) with that path's count
    sub_paths = {"hd256": "recurrentgemma-9b", **{arch: arch for arch, *_ in MOE_HEADS},
                 **{name: "qwen2-moe-a2.7b training" for name in MOE_GATHER_SHAPES},
                 "whisper-small": "whisper-small",
                 **{training_key(call): f"{call.split()[0]} training" for call in grad_check.FLASH_TRAIN_CALLS
                    if call != "qwen3-4b"}}
    training_path = {"flash_attention": "qwen3-4b training", "ssd_states": "mamba2-1.3b training",
                     "ssd_output": "mamba2-1.3b training", "rglru_scan": "recurrentgemma-9b training"}
    line = {"kernels": []}
    for k in KERNELS:
        counts = {arch: c[k] for arch, c in by_path.items() if k in c}
        entry = {"name": k, **KERNELS[k], "launches": next(iter(counts.values())), "launches_by_path": counts,
                 **results[k]}
        for key, path in {**sub_paths, "training": training_path.get(k)}.items():
            if key in entry:
                entry[key] = {**entry[key], "launches": counts[path]}
        line["kernels"].append(entry)
    print(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} s; seconds at the end of each: "
          + json.dumps({k: round(v, 1) for k, v in marks.items()}))
    print("kernels: " + json.dumps({e["name"]: {"launches": e["launches_by_path"], "max_abs_err": e["max_abs_err"]}
                                    for e in line["kernels"]}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    modes = {"--resume-check": resume_check, "--storage-check": storage_check, "--mutants": mutants_main,
             "--mesh-train-check": mesh_train_check, "--cpu-checks": cpu_checks}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:] and sys.argv[1] in modes else main())
