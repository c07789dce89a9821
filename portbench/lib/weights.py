"""The weights both sides use, made from the seed on the device.

One flat fp32 buffer is filled from one ``torch.Generator`` in a few large
calls; every parameter is a view of it, in the layout the port's
``Model.abstract_params()`` lists (the family's ``leaf_specs``), scaled by
its own rule: projections by 1/sqrt(fan-in), the embedding left at unit
variance, the norm scales at 1 + 0.1 z (not all ones, so a norm that drops
its scale shows).  The same seed gives the same bits on the same device, so
the reference regenerates the weights rather than reading the program's.
``fam`` is the configuration's family module (``lib/family.py``).
"""
from __future__ import annotations

import math

import torch

from portbench.lib.cell import derive

_SLAB = 1 << 30  # elements filled by one generator call


def make(fam, dm, seed: int, device) -> dict:
    """The parameter tree of ``dm`` for ``seed`` on ``device``, each leaf a
    view of one flat buffer."""
    specs = fam.leaf_specs(dm)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    for a in range(0, total, _SLAB):
        flat[a:a + _SLAB].normal_(generator=gen)
    views = []
    off = 0
    for _, shape, kind, std in specs:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if kind == "norm":
            leaf.mul_(std).add_(1.0)
        elif std != 1.0:
            leaf.mul_(std)
        views.append(leaf)
    return fam.tree(dm, views)
