"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

Every parameter of the model zoo has a tuple of *logical* axis names, one
per dim (e.g. ``("embed", "heads", "head_dim")``;
``transformer.param_logical_axes``).  ``AxisRules`` maps those names onto
the dims of a ``torch.distributed.device_mesh.DeviceMesh``, giving a
``PartitionSpec`` with the entries of the JAX package's, and
``placements`` turns a spec into DTensor placements.  ``AxisRules.null()``
shards nothing (one device); ``AxisRules.pod()`` is the production rule
set.

Importing this module touches no process group and does not import
``torch.distributed.tensor`` (about a second); the functions that need
DTensor import it.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import torch

AxisVal = Union[None, str, tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh-dim name, or a
    tuple of names (the dim split over several mesh dims, major to minor).
    Entries are normalised as JAX's ``PartitionSpec`` normalises them: an
    empty tuple becomes None and a tuple of one name the name."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _names(entry) -> tuple:
    """The mesh-dim names of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: Mapping[str, AxisVal]
    enabled: bool = True

    # -- constructors --------------------------------------------------------

    @staticmethod
    def null() -> "AxisRules":
        return AxisRules(rules={}, enabled=False)

    @staticmethod
    def pod(
        *,
        multi_pod: bool = False,
        fsdp: bool = True,
        fsdp_over_pod: bool = False,
        shard_heads: bool = True,
        shard_kv_heads: bool = True,
        seq_shard_attn: bool = False,
        tp: bool = True,
    ) -> "AxisRules":
        """Production rules for the (pod, data, model) / (data, model) mesh.

        - batch over ('pod','data'); TP dims over 'model'.
        - FSDP (ZeRO-3): the non-TP dim of every weight over 'data'
          (optionally ('pod','data'): cross-pod all-gathers, usually worse).
        - KV-cache sequence dim over 'model' (distributed flash-decode).
        - tp=False: no tensor parallelism; the 'model' axis becomes extra
          data parallelism (batch over (...,'model'), params FSDP over both
          axes).
        """
        dp: tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
        if not tp:
            dp_all = dp + ("model",)
            fsdp_axes = dp_all if fsdp else None
            return AxisRules(
                rules={
                    "batch": dp_all,
                    "seq": None,
                    "embed": fsdp_axes,
                    "embed_act": None,
                    "heads": None, "kv_heads": None, "head_dim": None,
                    "ff": None, "vocab": None,
                    "expert": None, "expert_ff": None, "expert_ff_tp": None,
                    "cache_batch": dp_all, "cache_seq": None,
                    "cache_heads": None, "layers": None,
                    "conv": None, "ssm_state": None, "inner": None,
                }
            )
        fsdp_axes = None
        if fsdp:
            fsdp_axes = dp if (fsdp_over_pod and multi_pod) else ("data",)
        return AxisRules(
            rules={
                "batch": dp,
                "seq": ("model",) if seq_shard_attn else None,
                "embed": fsdp_axes,        # FSDP dim of weights
                "embed_act": None,         # activation d_model dim
                # heads % model_size != 0 (arctic 56, musicgen 24, xlstm 4)
                # => replicate
                "heads": ("model",) if shard_heads else None,
                "kv_heads": ("model",) if shard_kv_heads else None,
                "head_dim": None,
                "ff": ("model",),
                "vocab": ("model",),
                "expert": ("model",),      # EP
                "expert_ff": None,         # MoEConfig.sharding == "ep"
                "expert_ff_tp": ("model",),  # MoEConfig.sharding == "tp"
                "cache_batch": dp,
                "cache_seq": ("model",),   # seq-sharded KV cache
                "cache_heads": None,
                "layers": None,
                "conv": None,
                "ssm_state": None,
                "inner": ("model",),       # mamba/xlstm expanded inner dim
            }
        )

    # -- use -----------------------------------------------------------------

    def axes(self, name: Optional[str]) -> AxisVal:
        if name is None:
            return None
        return self.rules.get(name)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        return PartitionSpec(*(self.axes(a) for a in logical_axes))

    def constrain(self, x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
        """Lay a DTensor out by its logical axes (a redistribute); a plain
        tensor is returned unchanged, and so is everything when the rules
        are disabled."""
        if not self.enabled:
            return x
        if len(logical_axes) != x.ndim:
            raise ValueError(f"{len(logical_axes)} logical axes {logical_axes} for a "
                             f"tensor of shape {tuple(x.shape)}")
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        mesh = x.device_mesh
        return x.redistribute(mesh, placements(mesh, self.spec(logical_axes), x.shape))


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(a is None or isinstance(a, str) for a in v)


def _map_axes(fn, axes_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(_map_axes(fn, v) for v in axes_tree)
    raise TypeError(f"not a logical-axes tree: {axes_tree!r}")


def tree_specs(axes_tree, rules: AxisRules):
    """Map a tree (dicts, lists) of logical-axis tuples to the same tree of
    PartitionSpecs."""
    return _map_axes(rules.spec, axes_tree)


def tree_shardings(axes_tree, rules: AxisRules, mesh):
    """The same tree of ``NamedSharding``s over ``mesh`` (for
    ``Checkpointer.restore(shardings=...)``)."""
    return _map_axes(lambda axes: NamedSharding(mesh, rules.spec(axes)), axes_tree)


def placements(mesh, spec: Sequence[AxisVal], shape) -> tuple:
    """DTensor placements (one per mesh dim) of a tensor of ``shape`` laid
    out by ``spec`` over ``mesh``.

    A tensor dim split over several mesh dims is split over them major to
    minor, as JAX splits it: DTensor shards ``[Shard(d), Shard(d)]`` in
    mesh-dim order, so the names of one entry must follow the mesh's order
    (``("pod", "data")``, not ``("data", "pod")``).  A dim that the mesh
    dims do not divide raises: DTensor would shard it unevenly, where the
    JAX package refuses it (``launch.elastic.reshard_tree`` replicates such
    dims first).
    """
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * mesh.ndim
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of {spec} is not a dim of the mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(set(idx)):
            raise ValueError(f"spec entry {entry!r} must name mesh dims once each, in the "
                             f"mesh's order {names}")
        size = 1
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims in {spec}")
            size *= mesh.size(i)
            out[i] = Shard(dim)
        if shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over {entry!r} "
                             f"({size} shards)")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor goes: a mesh and a PartitionSpec over its dims (the
    JAX ``NamedSharding``)."""

    mesh: object
    spec: PartitionSpec


def distribute(arr, sharding: NamedSharding):
    """A host array (numpy or CPU tensor) as a DTensor laid out by
    ``sharding``.  Every rank passes the same host array and keeps its own
    shard: no collective runs (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    mesh = sharding.mesh
    return distribute_tensor(t, mesh, placements(mesh, sharding.spec, t.shape),
                             src_data_rank=None)
