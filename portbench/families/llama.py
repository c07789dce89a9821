"""The Llama form: RMSNorm, rotary embedding over whole heads, grouped-query
attention, a SwiGLU MLP after every attention layer and an untied head
(``reference/model.py`` writes it down).  Yi-9B is of this form as
published; StableLM-3B-4E1T runs in it through its file's ``departures``.

The configuration files keep the published ``config.json`` keys (Hugging
Face's names) at their published values; ``dims`` reads them once, so the
rest of the benchmark does not depend on which model family named them.
"""
from __future__ import annotations

import dataclasses

from portbench.lib import cost
from portbench.reference.model import forward, loss  # noqa: F401  (the family's reference)


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

    @property
    def attn_layers(self) -> int:
        return self.layers


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


def arch(dm: Dims, cfg: dict):
    """The port's ``ArchConfig`` of a dense decoder of these sizes."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name=dm.name, family="dense", num_layers=dm.layers, d_model=dm.d_model,
                      num_heads=dm.heads, num_kv_heads=dm.kv_heads, d_ff=dm.d_ff,
                      vocab_size=dm.vocab, head_dim=dm.head_dim, rope_theta=dm.rope_theta,
                      norm_eps=dm.norm_eps, gated_mlp=True, tie_embeddings=False,
                      source=cfg["source"])


# -- the weights: the port's layout ------------------------------------------


def leaf_specs(dm: Dims) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, std) of every parameter, in generation order.
    ``kind`` is ``normal`` (std as given) or ``norm`` (1 + std * z)."""
    d, H, KV, hd, F, V = dm.d_model, dm.heads, dm.kv_heads, dm.head_dim, dm.d_ff, dm.vocab
    specs = [(("embed", "table"), (V, d), "normal", 1.0),
             (("final_norm", "scale"), (d,), "norm", 0.1),
             (("lm_head",), (V, d), "normal", d ** -0.5)]
    for l in range(dm.layers):
        b = ("blocks", l)
        specs += [(b + ("norm1", "scale"), (d,), "norm", 0.1),
                  (b + ("attn", "wq"), (d, H, hd), "normal", d ** -0.5),
                  (b + ("attn", "wk"), (d, KV, hd), "normal", d ** -0.5),
                  (b + ("attn", "wv"), (d, KV, hd), "normal", d ** -0.5),
                  (b + ("attn", "wo"), (H, hd, d), "normal", (H * hd) ** -0.5),
                  (b + ("norm2", "scale"), (d,), "norm", 0.1),
                  (b + ("ffn", "w_in"), (d, F), "normal", d ** -0.5),
                  (b + ("ffn", "w_gate"), (d, F), "normal", d ** -0.5),
                  (b + ("ffn", "w_out"), (F, d), "normal", F ** -0.5)]
    return specs


def tree(dm: Dims, views) -> dict:
    """The port's parameter tree from the leaves in ``leaf_specs`` order."""
    it = iter(views)
    out = {"embed": {"table": next(it)}, "final_norm": {"scale": next(it)},
           "lm_head": next(it), "blocks": []}
    for _ in range(dm.layers):
        out["blocks"].append({
            "norm1": {"scale": next(it)},
            "attn": {k: next(it) for k in ("wq", "wk", "wv", "wo")},
            "norm2": {"scale": next(it)},
            "ffn": {k: next(it) for k in ("w_in", "w_gate", "w_out")}})
    return out


def leaves(params: dict) -> list:
    """The leaves of a parameter tree in ``leaf_specs`` order."""
    out = [params["embed"]["table"], params["final_norm"]["scale"], params["lm_head"]]
    for b in params["blocks"]:
        out += [b["norm1"]["scale"], b["attn"]["wq"], b["attn"]["wk"], b["attn"]["wv"],
                b["attn"]["wo"], b["norm2"]["scale"], b["ffn"]["w_in"], b["ffn"]["w_gate"],
                b["ffn"]["w_out"]]
    return out


# -- a step's operations and least bytes (see lib/cost.py for what counts) ----


def block_linear_params(dm: Dims) -> int:
    """Weights of one block's products: q, k, v, o and the SwiGLU's three."""
    d, qd, kvd = dm.d_model, dm.heads * dm.head_dim, dm.kv_heads * dm.head_dim
    return d * qd + 2 * d * kvd + qd * d + 3 * d * dm.d_ff


def linear_params(dm: Dims) -> int:
    """Weights of every block's products (not the embedding or the head)."""
    return dm.layers * block_linear_params(dm)


def attention_flops(dm: Dims, batch: int, q_len: int, k_len: int) -> float:
    """QK^T and PV of every layer: 2 products of 2 FLOPs per pair and dim."""
    return 4.0 * batch * dm.heads * dm.head_dim * cost.causal_pairs(q_len, k_len) * dm.layers


def prefill_flops(dm: Dims, batch: int, length: int) -> float:
    """A prefill of ``batch`` prompts of ``length``: the blocks' products
    for every token, causal attention, the head at the last position."""
    tokens = batch * length
    return (2.0 * tokens * linear_params(dm) + attention_flops(dm, batch, length, length)
            + 2.0 * batch * dm.vocab * dm.d_model)


def decode_flops(dm: Dims, batch: int, position: int) -> float:
    """One decode step at ``position`` (0-based): one token a sequence
    against the ``position + 1`` keys then filled."""
    return (2.0 * batch * (linear_params(dm) + dm.vocab * dm.d_model)
            + attention_flops(dm, batch, 1, position + 1))


def train_flops(dm: Dims, batch: int, length: int) -> float:
    """Forward and backward of a training step (no recomputation): every
    product three times (forward, and the two gradients), attention's 2
    forward products and 4 backward ones, the head at every position."""
    tokens = batch * length
    return (6.0 * tokens * (linear_params(dm) + dm.vocab * dm.d_model)
            + 3.0 * attention_flops(dm, batch, length, length))


def decode_bytes(dm: Dims, batch: int, position: int) -> float:
    """Least bytes of one decode step: every weight read once (the
    embedding's rows of this step's tokens only), the k/v of the
    ``position + 1`` filled positions read once, this step's k/v written."""
    d, F32 = dm.d_model, cost.F32
    weights = (linear_params(dm) + dm.vocab * d + (2 * dm.layers + 1) * d) * F32
    kv_row = 2 * dm.kv_heads * dm.head_dim * F32 * dm.layers  # k and v of one position
    return weights + batch * d * F32 + batch * (position + 1) * kv_row + batch * kv_row
