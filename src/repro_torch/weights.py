"""Carry parameters over from the JAX package.

``params_from_jax`` takes the tree that the JAX ``Model.init(...)[0]``
returns, after ``jax.device_get`` / ``np.asarray`` (nested dicts of numpy
arrays), and returns the port's parameters.  Both packages keep the same
layouts (``wq`` (d,H,hd), ``wk``/``wv`` (d,KV,hd), ``wo`` (H,hd,d), MLP
``w_in``/``w_gate`` (d,ff) and ``w_out`` (ff,d), ``embed.table`` and
``lm_head`` (V,d)), so the conversion is a copy.  The only change of shape:
the JAX blocks are stacked over pattern repeats R under
``blocks["pos{i}"]``; the port lists one dict per layer, layer r*P + i.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a private, writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, *, device="cpu") -> dict:
    """The port's parameters from a JAX parameter tree of numpy arrays."""
    params = {k: _map(v, lambda a: _tensor(a, device))
              for k, v in tree.items() if k != "blocks"}
    stacked = tree["blocks"]
    P = len(stacked)
    R = np.asarray(next(_leaves(stacked["pos0"]))).shape[0]
    params["blocks"] = [
        _map(stacked[f"pos{i}"], lambda a, r=r: _tensor(np.asarray(a)[r], device))
        for r in range(R) for i in range(P)]
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
