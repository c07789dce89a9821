"""The weights both sides use, made from the seed on the device.

One flat fp32 buffer is filled from one ``torch.Generator`` in a few large
calls; every parameter is a view of it, in the layout the port's
``Model.abstract_params()`` lists (``leaf_specs``), scaled by its own
rule: projections by 1/sqrt(fan-in), the embedding left at unit variance,
the norm scales at 1 + 0.1 z (not all ones, so a norm that drops its
scale shows).  The same seed gives the same bits on the same device, so
the reference regenerates the weights rather than reading the program's.
"""
from __future__ import annotations

import math

import torch

from portbench.lib.cell import derive
from portbench.lib.dims import Dims

_SLAB = 1 << 30  # elements filled by one generator call


def leaf_specs(dm: Dims) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, std) of every parameter, in generation order.
    ``kind`` is ``normal`` (std as given) or ``norm`` (1 + std * z)."""
    d, H, KV, hd, F, V = dm.d_model, dm.heads, dm.kv_heads, dm.head_dim, dm.d_ff, dm.vocab
    specs = [(("embed", "table"), (V, d), "normal", 1.0),
             (("final_norm", "scale"), (d,), "norm", 0.1),
             (("lm_head",), (V, d), "normal", d ** -0.5)]
    for l in range(dm.layers):
        b = ("blocks", l)
        specs += [(b + ("norm1", "scale"), (d,), "norm", 0.1),
                  (b + ("attn", "wq"), (d, H, hd), "normal", d ** -0.5),
                  (b + ("attn", "wk"), (d, KV, hd), "normal", d ** -0.5),
                  (b + ("attn", "wv"), (d, KV, hd), "normal", d ** -0.5),
                  (b + ("attn", "wo"), (H, hd, d), "normal", (H * hd) ** -0.5),
                  (b + ("norm2", "scale"), (d,), "norm", 0.1),
                  (b + ("ffn", "w_in"), (d, F), "normal", d ** -0.5),
                  (b + ("ffn", "w_gate"), (d, F), "normal", d ** -0.5),
                  (b + ("ffn", "w_out"), (F, d), "normal", F ** -0.5)]
    return specs


def count(dm: Dims) -> int:
    """Number of parameters."""
    return sum(math.prod(shape) for _, shape, _, _ in leaf_specs(dm))


def make(dm: Dims, seed: int, device) -> dict:
    """The parameter tree of ``dm`` for ``seed`` on ``device``: nested
    dicts and a ``blocks`` list, each leaf a view of one flat buffer."""
    total = count(dm)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    for a in range(0, total, _SLAB):
        flat[a:a + _SLAB].normal_(generator=gen)
    views = []
    off = 0
    for _, shape, kind, std in leaf_specs(dm):
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if kind == "norm":
            leaf.mul_(std).add_(1.0)
        elif std != 1.0:
            leaf.mul_(std)
        views.append(leaf)
    return tree(dm, views)


def tree(dm: Dims, views) -> dict:
    """The port's parameter tree from the leaves in ``leaf_specs`` order."""
    it = iter(views)
    out = {"embed": {"table": next(it)}, "final_norm": {"scale": next(it)},
           "lm_head": next(it), "blocks": []}
    for _ in range(dm.layers):
        out["blocks"].append({
            "norm1": {"scale": next(it)},
            "attn": {k: next(it) for k in ("wq", "wk", "wv", "wo")},
            "norm2": {"scale": next(it)},
            "ffn": {k: next(it) for k in ("w_in", "w_gate", "w_out")}})
    return out


def leaves(params: dict) -> list:
    """The leaves of a parameter tree in ``leaf_specs`` order."""
    out = [params["embed"]["table"], params["final_norm"]["scale"], params["lm_head"]]
    for b in params["blocks"]:
        out += [b["norm1"]["scale"], b["attn"]["wq"], b["attn"]["wk"], b["attn"]["wv"],
                b["attn"]["wo"], b["norm2"]["scale"], b["ffn"]["w_in"], b["ffn"]["w_gate"],
                b["ffn"]["w_out"]]
    return out


def leaf_names(dm: Dims) -> list[str]:
    return [".".join(str(p) for p in path) for path, _, _, _ in leaf_specs(dm)]
