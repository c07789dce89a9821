"""The learned performance model (paper §3) in torch + numpy.

Pipeline (faithful to §3.2.1-§3.2.2, §6.6.2-§6.6.3): the shared
:class:`~repro_torch.core.modeling.pipeline.FeaturePipeline` front end
(float64 numpy), then an MLP regression — 3 hidden layers x 9 neurons,
tanh, adam — over (program features ++ config encoding) -> standardized
speedup, in float32 on the model's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.modeling.base import (EstimatorBase, assemble_rows,
                                            register_estimator)
from repro_torch.core.modeling.pipeline import FeaturePipeline
from repro_torch.device import resolve_device

__all__ = ["PerformanceModel", "FeaturePipeline", "assemble_rows"]


# ---------------------------------------------------------------------------
# MLP (plain tensors)
# ---------------------------------------------------------------------------


def _init_mlp(seed: int, in_dim: int, hidden: Sequence[int] = (9, 9, 9), *,
              device="cpu") -> list[dict]:
    """He-normal weights and zero biases, drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` and moved to ``device`` (so
    the draw does not depend on the device).  The JAX package draws from
    ``jax.random``: the same seed gives other numbers there."""
    gen = torch.Generator().manual_seed(seed)
    dims = [in_dim, *hidden, 1]
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=gen) * math.sqrt(2.0 / a)
        params.append({"w": w.to(device), "b": torch.zeros(b, device=device)})
    return params


def _mlp_forward(params, x):
    h = x
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    out = h @ params[-1]["w"] + params[-1]["b"]
    return out[..., 0]


def _adam_train(params, X, y, *, lr=1e-2, epochs=600):
    """Full-batch Adam on the mean squared error, as the JAX package writes
    it (bias-corrected m and v, eps outside the sqrt).  Returns new
    parameter tensors; the ones passed in are left as they were."""
    flat = [p.detach().clone().requires_grad_(True)
            for layer in params for p in (layer["w"], layer["b"])]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    new = [{"w": flat[2 * i], "b": flat[2 * i + 1]}
           for i in range(len(params))]
    loss = None
    for i in range(epochs):
        loss = torch.mean((_mlp_forward(new, X) - y) ** 2)
        grads = torch.autograd.grad(loss, flat)
        c1, c2 = 1 - 0.9 ** (i + 1), 1 - 0.999 ** (i + 1)
        with torch.no_grad():
            for j, (p, g) in enumerate(zip(flat, grads)):
                m[j] = 0.9 * m[j] + 0.1 * g
                v[j] = 0.999 * v[j] + 0.001 * g ** 2
                p -= lr * (m[j] / c1) / (torch.sqrt(v[j] / c2) + 1e-8)
    params = [{k: t.detach() for k, t in layer.items()} for layer in new]
    return params, float(loss.detach())


def _as_input(X: np.ndarray, device: torch.device) -> torch.Tensor:
    # the pipeline's float64 rows enter the MLP as float32, where the JAX
    # package's ``jnp.asarray`` (x64 off) puts them too
    return torch.as_tensor(np.asarray(X), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# The regression performance model (ours)
# ---------------------------------------------------------------------------


@register_estimator
@dataclasses.dataclass
class PerformanceModel(EstimatorBase):
    pipeline: FeaturePipeline
    mlp_params: list
    hidden: tuple = (9, 9, 9)

    kind = "mlp"

    @property
    def device(self) -> torch.device:
        return self.mlp_params[0]["w"].device

    @staticmethod
    def train(X_raw: np.ndarray, y_speedup: np.ndarray, *,
              hidden=(9, 9, 9), n_components: int = 9, epochs: int = 600,
              lr: float = 1e-2, seed: int = 0,
              device="cuda") -> "PerformanceModel":
        """X_raw rows = program features ++ config encoding; y = speedup.
        The MLP is trained on ``device``."""
        dev = resolve_device(device)
        pipe = FeaturePipeline.fit(X_raw, y_speedup, n_components=n_components)
        X = _as_input(pipe.transform(X_raw), dev)
        y = _as_input(pipe.transform_y(y_speedup), dev)
        params = _init_mlp(seed, X.shape[1], hidden, device=dev)
        params, _ = _adam_train(params, X, y, lr=lr, epochs=epochs)
        return PerformanceModel(pipe, params, tuple(hidden))

    def predict(self, X_raw: np.ndarray) -> np.ndarray:
        X = self.pipeline.transform(np.atleast_2d(X_raw))
        with torch.no_grad():
            yn = _mlp_forward(self.mlp_params, _as_input(X, self.device))
        return self.pipeline.inverse_y(yn.cpu().numpy())

    def refit(self, X_raw: np.ndarray, y_speedup: np.ndarray, *,
              epochs: int = 150, lr: float = 3e-3) -> float:
        """Incremental online refit: continue adam from the current
        parameters on freshly *measured* (features ++ config, speedup)
        rows.  The feature pipeline stays frozen so the input space is
        stable across refits; only the MLP moves.  Returns the final
        training loss."""
        X = self.pipeline.transform(np.atleast_2d(np.asarray(X_raw, float)))
        yn = self.pipeline.transform_y(
            np.asarray(y_speedup, float).reshape(-1))
        self.mlp_params, loss = _adam_train(
            self.mlp_params, _as_input(X, self.device),
            _as_input(yn, self.device), lr=lr, epochs=epochs)
        return float(loss)

    def fork(self) -> "PerformanceModel":
        """A refit-isolated copy sharing the frozen feature pipeline.

        The MLP's tensors are cloned, on the device they live on, so no
        write to either model's weights — in place or by a refit — can
        reach the other (per-tenant copy-on-refit in serving)."""
        return PerformanceModel(
            self.pipeline,
            [{k: t.clone() for k, t in layer.items()}
             for layer in self.mlp_params],
            self.hidden)

    def to(self, device) -> "PerformanceModel":
        """This model with its MLP on ``device`` (a copy when it moves)."""
        dev = resolve_device(device)
        return PerformanceModel(
            self.pipeline,
            [{k: t.to(dev) for k, t in layer.items()}
             for layer in self.mlp_params],
            self.hidden)

    # -- artifact serialization ----------------------------------------------

    def to_state(self) -> tuple[dict, dict]:
        arrays = self.pipeline.to_arrays()
        for i, layer in enumerate(self.mlp_params):
            arrays[f"mlp.{i}.w"] = layer["w"].detach().cpu().numpy()
            arrays[f"mlp.{i}.b"] = layer["b"].detach().cpu().numpy()
        return arrays, {"hidden": list(self.hidden),
                        "n_layers": len(self.mlp_params)}

    @classmethod
    def from_state(cls, arrays: dict, extras: dict) -> "PerformanceModel":
        """The model an artifact holds, on the CPU; ``.to(device)`` moves
        it."""
        pipe = FeaturePipeline.from_arrays(arrays)

        def weights(key):
            return torch.from_numpy(np.array(arrays[key], np.float32))

        params = [{"w": weights(f"mlp.{i}.w"), "b": weights(f"mlp.{i}.b")}
                  for i in range(int(extras["n_layers"]))]
        return cls(pipe, params, tuple(extras["hidden"]))
