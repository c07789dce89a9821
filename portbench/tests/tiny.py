"""Small configurations and runs for the CPU tests."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from portbench import run as pb_run  # noqa: E402
from portbench.lib import cell  # noqa: E402


def config(**over) -> dict:
    """A GQA decoder of the Llama form at a size the CPU runs in seconds."""
    cfg = {"name": "tiny", "source": "test", "hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "vocab_size": 512, "max_position_embeddings": 256, "rms_norm_eps": 1e-5,
           "rope_theta": 10000.0, "compute_dtype": "float32", "tf32": False}
    cfg.update(over)
    return cfg


def workload(name: str, **over) -> dict:
    """A committed cell's traffic and limits at a small size."""
    small = {"yi-9b.decode": dict(batch=4, prompt_lengths=[16], output_tokens=40,
                                  cache_positions=64, trace_boundaries=2),
             "yi-9b.prefill": dict(batch=2, prompt_lengths=[8, 16, 24], output_tokens=4,
                                   cache_positions=64),
             "stablelm-3b.train": dict(batch=2, seq_len=32)}[name]
    wl = dict(cell.workload(name), **small)
    wl.update(over)
    return wl


def run(name: str, wl: dict, cfg: dict, *, seed: int = 2**33 + 17, seconds: float = 0.3,
        trace: bool = False, controls: bool = False):
    """``run.execute`` on the CPU: (result, driver output)."""
    bench = cell.load_benchmark()
    return pb_run.execute(name, wl, cfg, seed=seed, seconds=seconds, trace=trace,
                          device=torch.device("cpu"), e2e=cell.end_to_end(bench, name),
                          per_layer=cell.per_layer(bench, name), controls=controls)
