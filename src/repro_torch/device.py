"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device.

    Asking for CUDA on a machine without a card raises: the port does not
    quietly carry on on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return dev


def kernel_path(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's path: true on CUDA, where the kernels
    run, and on the meta device, where the dry run
    (:mod:`repro_torch.launch.dryrun`) follows the card's path op for op with
    shapes only. A CPU tensor takes the plain path."""
    return t.is_cuda or t.is_meta
