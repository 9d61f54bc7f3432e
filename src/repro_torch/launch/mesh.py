"""Production mesh construction (single-pod 16x16 and 2-pod 2x16x16) (the
port of ``repro.launch.mesh``), as ``torch.distributed`` DeviceMeshes.

FUNCTIONS (not module-level constants), so that importing builds no mesh
and touches no process group. A mesh spans the default process group,
which the caller starts: the dry run a fake group of the production world
size, a launcher on the card NCCL at world size 1.
"""
from __future__ import annotations


def _mesh(device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``, over the default group (of 256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"):
    """Small mesh over the local ranks (tests / examples; on one card
    (1, 1) over NCCL at world size 1)."""
    return _mesh(device, (data, model), ("data", "model"))


def _sizes(mesh) -> dict:
    from repro_torch.models.sharding import mesh_shape

    return mesh_shape(mesh)


def dp_size(mesh) -> int:
    shape = _sizes(mesh)
    return shape.get("data", 1) * shape.get("pod", 1)


def tp_size(mesh) -> int:
    return _sizes(mesh).get("model", 1)
