"""A configuration file's sizes, under the names the harness uses.

The files keep the published ``config.json`` keys (Hugging Face's names)
at their published values; this reads them once, so the rest of the benchmark does not depend on
which model family named them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float

    @property
    def group(self) -> int:
        return self.heads // self.kv_heads


def dims(cfg: dict) -> Dims:
    """The sizes of a configuration file.  Its published keys keep their
    published values; how the harness runs it departs where the file says
    (``departures``): fp32 with TF32 off (``compute_dtype``, ``tf32``) and
    rotary embedding over whole heads (``rotary_factor_run`` where the
    published ``partial_rotary_factor`` is less).  A file that asks for
    another precision or rotary share raises."""
    run = (cfg.get("compute_dtype"), cfg.get("tf32"),
           cfg.get("rotary_factor_run", cfg.get("partial_rotary_factor", 1.0)))
    if run != ("float32", False, 1.0):
        raise ValueError(f"{cfg['name']}: the harness runs fp32, TF32 off, whole-head rotary; "
                         f"the file asks for {run}")
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    eps = cfg["rms_norm_eps"] if "rms_norm_eps" in cfg else cfg["layer_norm_eps"]
    return Dims(name=cfg["name"], layers=cfg["num_hidden_layers"], d_model=d, heads=heads,
                kv_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim", d // heads),
                d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                rope_theta=float(cfg["rope_theta"]), norm_eps=float(eps))
