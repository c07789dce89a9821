"""Fault-tolerant checkpointing in the JAX package's format: atomic
(tmp + rename), versioned, optionally asynchronous (a background thread),
with auto-resume from the latest *valid* step.

Format: one ``.npz`` per checkpoint (the tree flattened with '/'-joined
keys, list and tuple items as ``#i``) and a JSON manifest written LAST; a
checkpoint without its manifest is treated as torn and ignored on restore,
so a failure mid-write is harmless.  Either package restores the other's
checkpoints.

numpy has no bfloat16.  A bf16 tensor is stored as its uint16 bit
pattern under its key with the suffix ``::bfloat16``, and restored as a
bf16 tensor of the same bits; every other leaf is stored as its numpy
array.  ``restore`` returns CPU tensors (sequences as tuples, as the JAX
package restores them); the caller moves them to its device, or passes
``shardings`` to get each leaf distributed over a device mesh.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel.sharding_rules import distribute

_BF16 = "::bfloat16"


def _host(leaf) -> np.ndarray:
    """A private host copy of one leaf as numpy (bf16 as uint16 bits): the
    caller may go on updating the tensor in place while it is written."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        key = prefix[:-1]
        if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
            key += _BF16
        out[key] = _host(tree)
    return out


def _leaf(key: str, a: np.ndarray):
    if key.endswith(_BF16):
        return key[:-len(_BF16)], torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return key, torch.from_numpy(a)


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        key, val = _leaf(key, val)
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _restore_lists(root)


def _restore_lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.startswith("#") for k in node):
        items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
        return tuple(_restore_lists(v) for _, v in items)
    return {k: _restore_lists(v) for k, v in node.items()}


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: Optional[bool] = None):
        """The device-to-host fetch happens synchronously (a copy of every
        leaf, so later in-place updates do not reach the checkpoint);
        serialization happens on a background thread unless blocking."""
        flat = _flatten(tree)
        self.wait()
        blocking = (not self.async_save) if blocking is None else blocking
        if blocking:
            self._write(step, flat)
        else:
            self._pending = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._pending.start()

    def _write(self, step: int, flat: dict):
        path = os.path.join(self.dir, f"ckpt_{step:08d}")
        tmp = path + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, path + ".npz")
        manifest = {"step": step, "time": time.time(),
                    "arrays": len(flat)}
        mtmp = path + ".manifest.tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, path + ".manifest.json")
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = self.valid_steps()
        for s in steps[:-self.keep]:
            for suffix in (".npz", ".manifest.json"):
                p = os.path.join(self.dir, f"ckpt_{s:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    # -- restore -----------------------------------------------------------

    def valid_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.endswith(".manifest.json"):
                step = int(name[len("ckpt_"):-len(".manifest.json")])
                if os.path.exists(os.path.join(
                        self.dir, f"ckpt_{step:08d}.npz")):
                    steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, shardings=None):
        """(step, tree of CPU tensors) of ``step`` or the latest valid
        checkpoint; (None, None) when there is none.  ``shardings``, a tree
        of ``sharding_rules.NamedSharding`` of the checkpoint's structure
        (lists where it restores tuples), distributes each leaf over its
        mesh: the tree then holds DTensors."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        tree = _unflatten(flat)
        if shardings is not None:
            tree = tree_lib.map(distribute, tree, shardings)
        return step, tree
