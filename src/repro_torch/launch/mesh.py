"""Production mesh construction: the JAX package's ``repro/launch/mesh.py``
on ``torch.distributed``.

Functions, not module-level constants, so importing this module touches no
process group.  Single pod: 16x16 = 256 ranks (data x model).  Multi-pod:
2x16x16 = 512 ranks (pod x data x model); the 'pod' axis carries only data
parallelism + gradient reduction, keeping TP traffic intra-pod.  Both need
a default process group of that many ranks (``torch.distributed.
init_process_group``; the dry-run uses a fake one).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """Every rank of the default process group, as a 1D 'data' mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=("data",))
