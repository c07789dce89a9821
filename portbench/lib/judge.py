"""The numbers that decide ``correct``, each held to its limit.

Served tokens: the widest gap by which a served (greedy) token's logit
lies below the reference's best at its position, and the widest
difference between a served token's logit and the reference's.
Training: the gap of each step's loss, and of the norms of the first
gradient and of the parameters' change after the first steps by their
worst leaf, each gap measured against the reference's norm of that leaf or
of the median leaf, whichever is larger.  A number that is not a number
fails.
"""
from __future__ import annotations

import statistics
import sys

import torch

# leaves whose first reference gradient is under this share of the median
# leaf's move by round-off alone under Adam; their change is not compared
STILL_LEAF = 1e-3


def served(ref_logits: torch.Tensor, tokens: torch.Tensor, logits: torch.Tensor) -> dict:
    """Served tokens (...) with their logits (...) against the reference's
    logits (..., V) at their positions: ``max_gap``, the widest gap by
    which a token's reference logit lies below the reference's best, and
    ``logit_err``, the widest difference between a token's logit as served
    and as the reference has it."""
    at = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return {"max_gap": (ref_logits.max(dim=-1).values - at).max().item(),
            "logit_err": (logits - at).abs().max().item()}


def worst(readings: list[dict]) -> dict:
    """The largest reading of each number over several."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def leaf_gap(prog: list[float], ref: list[float], keep=None) -> float:
    """The worst leaf's |prog - ref| over max(ref, median ref)."""
    idx = range(len(ref)) if keep is None else keep
    med = statistics.median(ref[i] for i in idx)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in idx)


def moving_leaves(grad_raw: list[float]) -> list[int]:
    med = statistics.median(grad_raw)
    return [i for i, g in enumerate(grad_raw) if g >= STILL_LEAF * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training cell's three numbers from the program's and the
    reference's readings (``reference.train.steps``'s keys)."""
    n = len(ref["losses"])
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][:n], ref["losses"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving_leaves(ref["grad_raw"])),
    }


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that has a limit within it, {name: {"value", "limit"}})."""
    checks = {k: {"value": float(numbers[k]), "limit": v} for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())  # NaN fails
    return ok, checks


def print_checks(checks: dict, stream=sys.stderr) -> None:
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=stream, flush=True)
