"""A configuration's family: the module ``families/<family>.py`` named by
the ``family`` key of its file, found by file as the per-layer readers are.

A family module holds everything that depends on the form of the model, so
that a new form is added as new files only:

- ``dims(cfg)``: the file's sizes, under the family's own names, with at
  least ``name`` and ``vocab``; a family whose layers attend gives
  ``heads``, ``kv_heads``, ``head_dim`` and ``attn_layers`` (the layers that
  attend), which the attention kernels' readers take;
- ``arch(dm, cfg)``: the port's ``ArchConfig`` for those sizes;
- ``leaf_specs(dm)``: (path, shape, kind, std) of every parameter in the
  order the port's ``Model.abstract_params()`` lists them, ``tree(dm,
  leaves)`` the port's parameter tree from them and ``leaves(params)`` the
  leaves of a tree in that order (``lib/weights.py`` fills them);
- ``forward(params, tokens, dm, *, prec, logits_from, remat)`` and
  ``loss(params, tokens, labels, dm, *, prec, remat)``: the plain reference,
  which imports nothing of the port;
- ``prefill_flops``, ``decode_flops``, ``train_flops`` and ``decode_bytes``:
  a step's model operations and least bytes (``lib/readers.py``).

Nothing here imports the port.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

from portbench.lib.cell import BENCH

DIR = BENCH / "families"
_loaded: dict = {}


def load(name: str):
    """The module ``DIR/<name>.py``, loaded once a path."""
    path = (Path(DIR) / f"{name}.py").resolve()
    if path not in _loaded:
        if not path.exists():
            raise KeyError(f"no family {name!r}: {path} is missing")
        modname = f"portbench_family_{name}"
        spec = importlib.util.spec_from_file_location(modname, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[modname] = module  # dataclasses look their module up
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]


def of(cfg: dict):
    """The family module of a configuration file."""
    return load(cfg["family"])
