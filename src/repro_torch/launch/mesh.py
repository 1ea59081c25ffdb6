"""Device meshes, and the H100 figures the port's bounds are computed from.

:func:`make_host_mesh` builds a ``DeviceMesh`` over the ranks of the
process group the caller has initialised (``torch.distributed`` learns of
no cluster by itself: give ``init_process_group`` its address, world size
and rank). :func:`make_production_mesh` gives the production layouts' dim
sizes and names only: a single pod of 256 ranks as (data=16, model=16), two
pods as (pod=2, data=16, model=16). :func:`repro_torch.dist.logical_to_spec`
reads either.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM (data sheet): HBM3 bytes/s, dense bf16 tensor-core FLOP/s,
# fp32 FLOP/s outside the tensor cores, device memory in bytes
H100 = {
    "hbm_bw": 3.35e12,
    "peak_flops_bf16": 989e12,
    "peak_flops_fp32": 67e12,
    "hbm_bytes": 80e9,
}


@dataclass(frozen=True)
class MeshLayout:
    """A mesh's dim sizes and names, not instantiated."""

    dims: tuple[int, ...]
    names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.dims))

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_host_mesh(shape=None, axes=("data", "model"), device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` (default: (1, world size)) over the
    initialised process group, its dims named ``axes``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group (torch.distributed.init_process_group)")
    if shape is None:
        shape = (1, dist.get_world_size())
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))
