"""Stream configuration: the (#partitions, #tasks) pair the paper tunes.

Two realizations of the same concept (DESIGN.md §2):
  host backend  — #tasks   = transfer/compute pipeline chunks,
                  #partitions = per-task kernel sub-slices (cache blocking +
                  dispatch granularity);   used by the CPU reproduction.
  mesh backend  — #tasks   = microbatches per training step (grad-accum
                  pipeline), #partitions = sub-meshes of the data axis;
                  used at pod scale.
"""
from __future__ import annotations

import dataclasses
import itertools


@dataclasses.dataclass(frozen=True, order=True)
class StreamConfig:
    partitions: int
    tasks: int

    def __post_init__(self):
        assert self.partitions >= 1 and self.tasks >= 1

    @property
    def single_stream(self) -> bool:
        return self.partitions == 1 and self.tasks == 1

    def as_tuple(self) -> tuple[int, int]:
        return (self.partitions, self.tasks)

    # JSON forms used by the persistent tuning cache
    def to_json(self) -> list[int]:
        return [self.partitions, self.tasks]

    @staticmethod
    def from_json(d) -> "StreamConfig":
        p, t = d
        return StreamConfig(int(p), int(t))


SINGLE_STREAM = StreamConfig(1, 1)


def default_space(
    max_partitions: int = 32,
    max_tasks: int = 64,
) -> list[StreamConfig]:
    """The candidate grid searched at runtime (paper §3.1.2: 1..224 x 1..256
    on XeonPhi; powers of two here to keep the CPU profile budget sane —
    the model itself accepts ANY configuration, including off-grid ones)."""
    parts = _pow2_upto(max_partitions)
    tasks = _pow2_upto(max_tasks)
    return [StreamConfig(p, t) for p, t in itertools.product(parts, tasks)]


def dense_space(max_partitions: int = 16, max_tasks: int = 64,
                step: int = 1) -> list[StreamConfig]:
    """A denser grid used to demonstrate generalization to configs that
    were never profiled during training (regression-model advantage)."""
    return [
        StreamConfig(p, t)
        for p in range(1, max_partitions + 1, step)
        for t in range(1, max_tasks + 1, step)
        if t >= p  # fewer tasks than partitions leaves partitions idle
    ]


def _pow2_upto(n: int) -> list[int]:
    out = []
    v = 1
    while v <= n:
        out.append(v)
        v *= 2
    return out
