"""Mesh backend: temporal sharing in training via microbatched gradient
accumulation (the JAX package's ``core/backends/mesh.py``).

``wrap_train_step`` splits the global batch into ``config.tasks``
microbatches, each a forward and a backward whose gradients autograd adds
into the parameters' ``.grad``; the sum is divided by the number of
microbatches at the end, as the JAX step divides its fp32 sum.  Adding into
``.grad`` needs no second copy of the parameters' size beyond the
gradients themselves.  On one card the backward of microbatch i+1 has no
collective to overlap with; the data-parallel reduce comes with the
sharding slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.backends.base import StreamBackend


def _grads(params):
    """The tree of ``.grad``s (zeros where a leaf got none, as
    ``jax.value_and_grad`` gives zeros), detached from the leaves."""
    def one(p):
        g = p.grad
        p.grad = None
        return torch.zeros_like(p) if g is None else g
    return tree_lib.map(one, params)


class MeshBackend(StreamBackend):
    name = "mesh"
    kind = "train-step"

    def wrap_train_step(self, loss_fn: Callable, config) -> Callable:
        """Wrap ``loss_fn(params, batch) -> (loss, metrics)`` into
        ``step(params, batch) -> (loss, metrics, grads)``: the mean loss and
        the mean gradient over ``config.tasks`` microbatches, each the
        next ``B / tasks`` rows of every batch entry, and the last
        microbatch's metrics.  ``params`` is a tree of leaf tensors; each is
        made to require grad, and its ``.grad`` is handed back in ``grads``
        and cleared.  (The JAX ``unroll`` flag, an unrolled loop or a
        ``lax.scan``, has no counterpart in eager PyTorch.)"""
        n_micro = config.tasks

        def step(params, batch):
            for p in tree_lib.leaves(params):
                p.requires_grad_(True)
                p.grad = None
            rows = next(iter(batch.values())).shape[0]
            if rows % n_micro:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{n_micro} microbatches")
            mb = rows // n_micro
            loss_sum, metrics = None, None
            for i in range(n_micro):
                micro = batch if n_micro == 1 else {
                    k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                loss, metrics = loss_fn(params, micro)
                loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = _grads(params)
            if n_micro > 1:
                with torch.no_grad():
                    for g in tree_lib.leaves(grads):
                        g.div_(n_micro)
                loss_sum = loss_sum / n_micro
            metrics = {k: v.detach() for k, v in metrics.items()}
            return loss_sum, metrics, grads

        return step
