"""The inputs both sides get, drawn from the seed on the device: a serving
batch's prompts and a training step's tokens.  Every seed gets the same
sizes and schedule; the seed changes only the token ids (and the weights).
``dm`` is a family's sizes (``lib/family.py``); only its ``vocab`` is read."""
from __future__ import annotations

import torch

from portbench.lib.cell import derive


def _randint(dm, shape, seed: int, keys, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(derive(seed, *keys))
    return torch.randint(0, dm.vocab, shape, generator=gen, device=device)


def prompts(dm, wl: dict, seed: int, index: int, device) -> torch.Tensor:
    """(batch, length) token ids of serving batch ``index``; the lengths
    cycle through ``prompt_lengths``."""
    lengths = wl["prompt_lengths"]
    return _randint(dm, (wl["batch"], lengths[index % len(lengths)]), seed,
                    ("prompts", index), device)


def train_batch(dm, wl: dict, seed: int, step: int, device) -> dict:
    """Training step ``step``'s (0-based) batch: ``tokens`` and the next
    token of each as ``labels``, (batch, seq_len) each."""
    t = _randint(dm, (wl["batch"], wl["seq_len"] + 1), seed, ("train", step), device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}
