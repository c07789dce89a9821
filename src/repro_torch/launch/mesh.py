"""Production mesh construction.

Functions, not module-level constants: importing this module touches no
process group.  A mesh is built over the current default process group
(``torch.distributed.init_process_group``, which the caller sets up), one
rank per device, with its device type taken from the explicit ``device``.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def _mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """(data 16, model 16) over 256 ranks, or (pod 2, data 16, model 16)
    over 512."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def make_test_mesh(data: int = 2, model: int = 2, *, device="cuda") -> DeviceMesh:
    """A small (data, model) mesh; the world size must be data * model."""
    return _mesh((data, model), ("data", "model"), device)


def dp_axes_of(mesh: DeviceMesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
