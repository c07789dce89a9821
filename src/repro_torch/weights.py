"""Carry parameters over from the JAX package.

``perf_model_from_jax`` turns a JAX ``PerformanceModel`` (its feature
pipeline and ``mlp_params``) into the port's, on the CPU.

``params_from_jax`` takes the tree that the JAX ``Model.init(...)[0]``
returns, after ``jax.device_get`` / ``np.asarray`` (nested dicts of numpy
arrays), and returns the port's parameters.  Both packages keep the same
layouts (``wq`` (d,H,hd), ``wk``/``wv`` (d,KV,hd), ``wo`` (H,hd,d), MLP
``w_in``/``w_gate`` (d,ff) and ``w_out`` (ff,d), ``embed.table`` and
``lm_head`` (V,d); mamba ``A_log``/``D`` and the rest of its block, the
MoE ``router``/``w_in``/``w_gate``/``w_out``/``dense``, the sLSTM and
mLSTM ``cell`` dicts), so the conversion is a copy.  The only change of
shape: the JAX blocks are stacked over pattern repeats R under
``blocks["pos{i}"]``; the port lists one dict per layer, layer r*P + i.
``cache_from_jax`` unstacks a JAX decode cache the same way, and
``opt_state_from_jax`` the AdamW moments.
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


def _unstack(stacked: dict, device) -> list:
    """``{"pos{i}": tree stacked over R}`` -> one tree per layer r*P + i."""
    P = len(stacked)
    R = np.asarray(next(_leaves(stacked["pos0"]))).shape[0]
    return [_map(stacked[f"pos{i}"], lambda a, r=r: _tensor(np.asarray(a)[r], device))
            for r in range(R) for i in range(P)]


def params_from_jax(tree: dict, *, device="cpu") -> dict:
    """The port's parameters from a JAX parameter tree of numpy arrays."""
    params = {k: _map(v, lambda a: _tensor(a, device))
              for k, v in tree.items() if k != "blocks"}
    params["blocks"] = _unstack(tree["blocks"], device)
    return params


def opt_state_from_jax(state: dict, *, device="cpu") -> dict:
    """The port's AdamW state from a JAX one (``step`` and the moments
    ``m``/``v``, numpy arrays): the moments unstacked as the parameters
    are; the step a host int32 scalar."""
    return {"step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32),
            "m": params_from_jax(state["m"], device=device),
            "v": params_from_jax(state["v"], device=device)}


def cache_from_jax(tree: dict, *, device="cpu") -> list:
    """The port's per-layer decode cache from a JAX cache (``pos{i}``
    state dicts stacked over R, as numpy arrays): k/v, or the recurrent
    states (mamba ``ssm``/``conv``, sLSTM ``c/n/h/m``, mLSTM ``C/n/m``)."""
    return _unstack(tree, device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def perf_model_from_jax(jax_model):
    """The port's ``PerformanceModel`` holding the same feature pipeline
    and MLP weights as the JAX package's ``jax_model``, on the CPU
    (``.to(device)`` moves it)."""
    from repro_torch.core.modeling.perf_model import (FeaturePipeline,
                                                      PerformanceModel)

    pipe = FeaturePipeline.from_arrays(jax_model.pipeline.to_arrays())
    params = [{k: _tensor(np.asarray(layer[k], np.float32), "cpu")
               for k in ("w", "b")} for layer in jax_model.mlp_params]
    return PerformanceModel(pipe, params, tuple(jax_model.hidden))
