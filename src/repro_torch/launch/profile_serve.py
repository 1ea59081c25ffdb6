"""Where the serving time goes on the card: ``torch.profiler`` over a window
of the serving path, after a warm-up request.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch qwen3-4b \
        --requests 4 --prompt-len 128 --max-new 16 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch mamba2-1.3b \
        --requests 4 --prompt-len 1024 --max-new 16 --max-batch 4 --max-len 1280
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch recurrentgemma-9b \
        --requests 4 --prompt-len 2048 --max-new 16 --max-batch 4 --max-len 2112
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch qwen2-moe-a2.7b \
        --requests 4 --prompt-len 128 --max-new 16 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch whisper-small \
        --requests 4 --prompt-len 128 --max-new 16 --max-batch 4

Prints the window's wall time (timed once without the profiler, then run
again under it), the device's busy time (the sum of its kernel and copy
times: one stream, so they do not overlap), the busy share, the device
time by kernel group and of the top kernels, and the device time by kernel
group inside each part of the path that runs (``PARTS``: a MoE model's
whole MoE FFN and its dispatch, which builds the expert table and gathers
the tokens into it; whisper's encoder). A part is a set of the program's
own spans (:mod:`repro_torch.trace`), which open while the profiler
records. The last line is the same as one JSON object. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve

GROUPS = [  # (group, substrings of the kernel name), first match wins
    ("flash_attention kernel", ("flash_fwd_mma_kernel", "flash_fwd_kernel")),  # bf16, fp32
    ("paged_decode kernel", ("paged_decode_partial_kernel", "paged_decode_combine_kernel")),
    ("ssd_states kernel", ("ssd_states_mma_kernel", "ssd_states_kernel")),  # bf16, fp32
    ("ssd_output kernel", ("ssd_output_mma_kernel", "ssd_output_kernel")),
    ("rglru_scan kernel", ("rglru_chunk_kernel",)),
    ("moe_gather kernels", ("gather_rows_kernel", "gather_sum_rows_kernel")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass", "xmma", "splitk", "cublas", "nvjet")),
    ("copy/fill", ("memcpy", "memset", "copy", "fill")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
]


PARTS = {  # part of the serving path: the program's spans whose launches it covers
    "moe ffn": ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared"),
    "moe dispatch": ("moe.dispatch",),
    "whisper encoder": ("whisper.encode",),
}


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_time(prof, parts: dict) -> tuple[dict, dict]:
    """(device ms by kernel group, {part: device ms by kernel group}): a
    part's kernels are those that start on the device inside the device-side
    ranges of its spans (``parts``: {part: span names})."""
    of_span = defaultdict(list)  # "repro_torch.<span>" → the parts it belongs to
    for part, names in parts.items():
        for name in names:
            of_span[trace.PREFIX + name].append(part)
    kernels, ranges = [], defaultdict(list)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith(trace.PREFIX):
            for part in of_span.get(e.name, ()):
                ranges[part].append((e.time_range.start, e.time_range.end))
        else:
            kernels.append((e.time_range.start, group_of(e.name), e.time_range.elapsed_us() / 1e3))
    by_group: dict[str, float] = defaultdict(float)
    by_part: dict[str, dict] = {name: defaultdict(float) for name in ranges}
    for start, group, ms in kernels:
        by_group[group] += ms
        for name, spans in ranges.items():
            if any(a <= start < b for a, b in spans):
                by_part[name][group] += ms
    return dict(by_group), {name: dict(g) for name, g in by_part.items()}


def top_kernels(prof, n: int = 12) -> dict:
    """The ``n`` kernels of most device time: {name (cut to 90 characters):
    ms}, the spans' device-side ranges left out."""
    by_kernel: dict[str, float] = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(trace.PREFIX):
            by_kernel[e.name] += e.time_range.elapsed_us()
    return {k[:90]: v / 1e3 for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n]}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=serve.MAX_LEN)
    args = ap.parse_args(argv)

    model = serve.build(get_config(args.arch), resolve_device("cuda"))
    window = dict(requests=args.requests, prompt_len=args.prompt_len, max_new=args.max_new,
                  max_batch=args.max_batch, max_len=args.max_len)
    serve.run(model, **{**window, "requests": 1})  # warm-up: kernel builds, cuBLAS, allocator
    _, plain = serve.run(model, **window)  # the window without the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, m = serve.run(model, **window)

    by_group, by_part = device_time(prof, PARTS)
    busy = sum(by_group.values()) / 1e3
    wall = plain["wall_s"]
    out = {
        "device": torch.cuda.get_device_name(0), "arch": model.cfg.name, "layers": model.cfg.n_layers,
        **{k: m[k] for k in ("requests", "tokens", "prefill_calls", "decode_calls")},
        "wall_s": wall, "wall_profiled_s": m["wall_s"], "device_busy_s": busy, "busy_share": busy / wall,
        "groups_ms": {g: v for g, v in sorted(by_group.items(), key=lambda kv: -kv[1])},
        "parts_ms": by_part,
        "top_kernels_ms": top_kernels(prof),
    }
    print(f"window: {wall:.3f} s wall ({m['wall_s']:.3f} s profiled), device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), {m['prefill_calls']} prefills, {m['decode_calls']} decode calls")
    for g, v in out["groups_ms"].items():
        print(f"  {g:24s} {v:10.3f} ms")
    for part, groups in by_part.items():
        print(f"  part {part}: {sum(groups.values()):.3f} ms, "
              + ", ".join(f"{g} {v:.3f}" for g, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
