"""Production mesh factory (PyTorch port of `repro.launch.mesh`).

FUNCTIONS, not module-level constants: importing this module touches no
device and no process-group state.

Single pod:  (16, 16)      axes ("data", "model")         = 256 devices
Multi-pod :  (2, 16, 16)   axes ("pod", "data", "model")  = 512 devices;
             the "pod" axis is the cross-pod boundary — gradients reduce
             over it, weights FSDP over (pod, data).

`MeshShape` is the ordered axis -> size map the sharding rules read
(`distributed.sharding.resolve_spec`); `make_production_mesh` lays it over
the default process group as a `DeviceMesh`, whose world size must be the
mesh's device count: 256 or 512 processes, or one process of a "fake"
group of that size (`launch.dryrun` opens one).  `make_test_mesh` lays a
(data, model) mesh over a live group of `distributed.runtime` ranks, on
"cpu" (gloo) or "cuda" (nccl, one card a rank, or gloo, the ranks sharing
one card).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshShape:
    axes: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_mesh(shape: MeshShape, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape.sizes} mesh needs a process group of "
                           f"world size {shape.size}; none is open")
    world = dist.get_world_size()
    if world != shape.size:
        raise ValueError(f"a {shape.sizes} mesh needs a process group of "
                         f"world size {shape.size}, not {world}")
    return init_device_mesh(device_type, shape.sizes,
                            mesh_dim_names=shape.axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The production `DeviceMesh` over the default process group, whose
    world size must be 256 (single pod) or 512 (multi-pod)."""
    return _device_mesh(production_mesh_shape(multi_pod=multi_pod),
                        device_type)


def make_test_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A (data, model) `DeviceMesh` over the default process group, whose
    world size must be data * model."""
    return _device_mesh(MeshShape(("data", "model"), (data, model)),
                        device_type)
