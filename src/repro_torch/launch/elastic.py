"""Elastic scaling: remesh a running job when the healthy device count
changes (node failure, capacity added).

The checkpoint format is mesh-independent (host numpy trees), so an
elastic restore rebuilds the mesh from the surviving ranks, rebuilds the
shardings from the same logical-axis rules, and distributes the restored
tree (``reshard_tree``).

Losing devices, in torch: every rank of the current default process group
calls ``build_mesh`` with the surviving ranks; the ``DeviceMesh`` it
returns is built from ``dist.new_group`` subgroups of those ranks only
(``new_group`` is collective over the default group, so a rank left out
calls it too and gets a mesh it is not part of).  A job whose lost ranks
are really gone restarts its process group over the survivors first (for
example under torchelastic), then builds the mesh the same way.
``simulate_failure_and_remesh`` is the harness the tests use: all ranks
live, the last ``lost_devices`` of the old mesh left out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree as tree_lib
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding_rules import (AxisRules, NamedSharding,
                                                 PartitionSpec, distribute,
                                                 tree_specs)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int

    @property
    def size(self) -> int:
        return self.data * self.model


def plan_remesh(n_devices: int, *, prefer_model: int) -> MeshPlan:
    """Choose a (data, model) factorization for the surviving devices:
    keep the model axis as close to `prefer_model` as divisibility allows
    (TP degree is constrained by weight shapes), put the rest on data."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return MeshPlan(data=n_devices // model, model=model)


def build_mesh(plan: MeshPlan, ranks: Optional[Sequence[int]] = None, *,
               device="cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the first ``plan.size`` of ``ranks``
    (global ranks of the default process group; all of them by default),
    data-major, on ``device``'s type.  Every rank of the default group
    calls it."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if len(ranks) < plan.size:
        raise ValueError(f"{len(ranks)} ranks for a {plan.data} x {plan.model} mesh")
    grid = torch.tensor(ranks[: plan.size], dtype=torch.int64)
    return DeviceMesh(resolve_device(device).type, grid.reshape(plan.data, plan.model),
                      mesh_dim_names=("data", "model"))


def reshard_tree(host_tree, axes_tree, mesh: DeviceMesh, rules: Optional[AxisRules] = None):
    """Distribute a host (numpy or CPU tensor) tree over ``mesh`` by its
    logical axes: a tree of DTensors, each rank holding its shard.

    Elastic meshes can have odd axis sizes (e.g. 6 devices -> model=3);
    dims that no longer divide are replicated, as in the JAX package
    (DTensor would shard them unevenly)."""
    rules = rules or AxisRules.pod()
    specs = tree_specs(axes_tree, rules)
    names = list(mesh.mesh_dim_names)

    def put(arr, spec):
        fitted = []
        for dim, entry in zip(arr.shape, tuple(spec) + (None,) * arr.ndim):
            size = 1
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                size *= mesh.size(names.index(a))
            fitted.append(entry if dim % size == 0 else None)
        return distribute(arr, NamedSharding(mesh, PartitionSpec(*fitted)))

    return tree_lib.map(put, host_tree, specs)


def simulate_failure_and_remesh(host_tree, axes_tree, *, old_mesh: DeviceMesh,
                                lost_devices: int, prefer_model: int):
    """Test harness: drop the last ``lost_devices`` ranks of ``old_mesh``,
    replan, reshard.  Returns (new_mesh, resharded_tree); on a dropped rank
    the tree holds empty shards."""
    survivors = old_mesh.mesh.flatten().tolist()[: old_mesh.size() - lost_devices]
    plan = plan_remesh(len(survivors), prefer_model=prefer_model)
    new_mesh = build_mesh(plan, survivors, device=old_mesh.device_type)
    return new_mesh, reshard_tree(host_tree, axes_tree, new_mesh)
