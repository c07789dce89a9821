"""The Jamba form (AI21's Jamba and Jamba2): a period of Mamba-1 mixers with
one attention layer, RoPE-free, at ``i % attn_layer_period ==
attn_layer_offset``; after every mixer a SwiGLU FFN, a dropless top-K MoE
(gates not renormalised) at ``i % expert_layer_period ==
expert_layer_offset`` and a dense MLP elsewhere, each ``intermediate_size``
wide; RMSNorms on the mixer's dt, B and C; an untied head
(``reference/jamba.py`` writes it down).

The configuration file keeps the published ``config.json`` keys (Hugging
Face's names); ``dims`` reads them once.  The port runs it through
``ArchConfig``'s opt-in fields: ``rope=False``, ``MoEConfig(dropless=True,
renormalize=False)``, ``SSMConfig(inner_norms=True)``.  No training cell
runs it, so ``loss`` and ``train_flops`` raise.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from portbench.lib import cost
from portbench.reference.jamba import forward, run  # noqa: F401  (the family's reference)

# dt drawn log-uniformly in this range, as Mamba's initialisation draws it
DT_MIN, DT_MAX = 1e-3, 1e-1


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
    norm_eps: float
    experts: int
    top_k: int
    d_state: int
    d_conv: int
    expand: int
    dt_rank: int
    kinds: tuple     # "attn" or "mamba", a layer
    moe: tuple       # True where a layer's FFN is the MoE

    @property
    def group(self) -> int:
        return self.heads // self.kv_heads

    @property
    def inner(self) -> int:
        return self.expand * self.d_model

    @property
    def attn_layers(self) -> int:
        return self.kinds.count("attn")

    @property
    def mamba_layers(self) -> int:
        return self.kinds.count("mamba")

    @property
    def moe_layers(self) -> int:
        return sum(self.moe)


def dims(cfg: dict) -> Dims:
    """The sizes of a configuration file.  The run departs from the
    published model only in precision (``compute_dtype`` float32, ``tf32``
    false); a file that asks for another, or for what the port's Jamba
    lacks (tied embeddings, projection biases, a mixer conv without bias, a
    sliding window), raises."""
    if (cfg.get("compute_dtype"), cfg.get("tf32")) != ("float32", False):
        raise ValueError(f"{cfg['name']}: the harness runs fp32 with TF32 off")
    if (cfg["tie_word_embeddings"], cfg["mamba_proj_bias"], cfg["mamba_conv_bias"],
            cfg["sliding_window"]) != (False, False, True, None):
        raise ValueError(f"{cfg['name']}: the port's Jamba has an untied head, no projection "
                         f"biases, a conv bias and full attention")
    n, d, heads = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_attention_heads"]
    ap, ao = cfg["attn_layer_period"], cfg["attn_layer_offset"]
    ep, eo = cfg["expert_layer_period"], cfg["expert_layer_offset"]
    if n % ap or ap % ep:
        raise ValueError(f"{cfg['name']}: {n} layers are not whole periods of {ap} "
                         f"with experts every {ep}")
    return Dims(name=cfg["name"], layers=n, d_model=d, heads=heads,
                kv_heads=cfg["num_key_value_heads"], head_dim=d // heads,
                d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                norm_eps=float(cfg["rms_norm_eps"]), experts=cfg["num_experts"],
                top_k=cfg["num_experts_per_tok"], d_state=cfg["mamba_d_state"],
                d_conv=cfg["mamba_d_conv"], expand=cfg["mamba_expand"],
                dt_rank=cfg["mamba_dt_rank"],
                kinds=tuple("attn" if i % ap == ao else "mamba" for i in range(n)),
                moe=tuple(cfg["num_experts"] > 1 and i % ep == eo for i in range(n)))


def arch(dm: Dims, cfg: dict):
    """The port's ``ArchConfig``: one attention period as the layer pattern."""
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

    period = cfg["attn_layer_period"]
    return ArchConfig(
        name=dm.name, family="hybrid", num_layers=dm.layers, d_model=dm.d_model,
        num_heads=dm.heads, num_kv_heads=dm.kv_heads, d_ff=dm.d_ff, vocab_size=dm.vocab,
        layer_pattern=dm.kinds[:period], ffn_on="all",
        moe_layer_indices=tuple(i for i in range(period) if dm.moe[i]),
        moe=MoEConfig(num_experts=dm.experts, top_k=dm.top_k, expert_d_ff=dm.d_ff,
                      dropless=True, renormalize=False),
        ssm=SSMConfig(state_dim=dm.d_state, conv_width=dm.d_conv, expand=dm.expand,
                      dt_rank=dm.dt_rank, inner_norms=True),
        head_dim=dm.head_dim, norm_eps=dm.norm_eps, gated_mlp=True, tie_embeddings=False,
        rope=False, subquadratic=True, source=cfg["source"])


# -- the weights: the port's layout ------------------------------------------


def _mamba_specs(dm: Dims, b: tuple) -> list:
    d, E, N, R, W = dm.d_model, dm.inner, dm.d_state, dm.dt_rank, dm.d_conv
    m = b + ("mamba",)
    return [(m + ("in_proj",), (d, 2 * E), "normal", d ** -0.5),
            (m + ("conv_w",), (W, E), "normal", W ** -0.5),
            (m + ("conv_b",), (E,), "normal", 0.1),
            (m + ("x_proj",), (E, R + 2 * N), "normal", E ** -0.5),
            (m + ("dt_proj",), (R, E), "normal", R ** -0.5),
            (m + ("dt_bias",), (E,), "normal", 1.0),   # set by ``tree``
            (m + ("A_log",), (E, N), "normal", 1.0),   # set by ``tree``
            (m + ("D",), (E,), "normal", 1.0),         # set by ``tree``
            (m + ("out_proj",), (E, d), "normal", E ** -0.5),
            (m + ("dt_norm", "scale"), (R,), "norm", 0.1),
            (m + ("B_norm", "scale"), (N,), "norm", 0.1),
            (m + ("C_norm", "scale"), (N,), "norm", 0.1)]


def leaf_specs(dm: Dims) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, std) of every parameter, in the order the port's
    ``init_params`` makes them.  ``kind`` is ``normal`` (std as given) or
    ``norm`` (1 + std * z)."""
    d, H, KV, hd, F, V, X = (dm.d_model, dm.heads, dm.kv_heads, dm.head_dim, dm.d_ff,
                             dm.vocab, dm.experts)
    specs = [(("embed", "table"), (V, d), "normal", 1.0),
             (("final_norm", "scale"), (d,), "norm", 0.1),
             (("lm_head",), (V, d), "normal", d ** -0.5)]
    for l in range(dm.layers):
        b = ("blocks", l)
        specs.append((b + ("norm1", "scale"), (d,), "norm", 0.1))
        if dm.kinds[l] == "attn":
            specs += [(b + ("attn", "wq"), (d, H, hd), "normal", d ** -0.5),
                      (b + ("attn", "wk"), (d, KV, hd), "normal", d ** -0.5),
                      (b + ("attn", "wv"), (d, KV, hd), "normal", d ** -0.5),
                      (b + ("attn", "wo"), (H, hd, d), "normal", (H * hd) ** -0.5)]
        else:
            specs += _mamba_specs(dm, b)
        specs.append((b + ("norm2", "scale"), (d,), "norm", 0.1))
        f = b + ("ffn",)
        if dm.moe[l]:
            specs += [(f + ("router",), (d, X), "normal", d ** -0.5),
                      (f + ("w_in",), (X, d, F), "normal", d ** -0.5),
                      (f + ("w_out",), (X, F, d), "normal", F ** -0.5),
                      (f + ("w_gate",), (X, d, F), "normal", d ** -0.5)]
        else:
            specs += [(f + ("w_in",), (d, F), "normal", d ** -0.5),
                      (f + ("w_out",), (F, d), "normal", F ** -0.5),
                      (f + ("w_gate",), (d, F), "normal", d ** -0.5)]
    return specs


def _mamba_init(m: dict) -> None:
    """Mamba's published initialisation of the leaves it fixes, in place:
    A_log = log(1..N) for each channel, D = 1, and dt_bias the inverse
    softplus of a dt drawn log-uniformly in [DT_MIN, DT_MAX], the uniform
    draw being Phi of the leaf's own normal draw.  The recurrence then keeps
    a memory over hundreds of positions, as a trained model's does."""
    N = m["A_log"].shape[1]
    m["A_log"].copy_(torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                            device=m["A_log"].device)).expand_as(m["A_log"]))
    m["D"].fill_(1.0)
    u = m["dt_bias"].div_(math.sqrt(2.0)).erf_().add_(1.0).mul_(0.5)
    dt = u.mul_(math.log(DT_MAX / DT_MIN)).add_(math.log(DT_MIN)).exp_()
    dt.add_(torch.log(-torch.expm1(-dt)))  # softplus(dt + log(1 - e^-dt)) = dt


def tree(dm: Dims, views) -> dict:
    """The port's parameter tree from the leaves in ``leaf_specs`` order."""
    it = iter(views)
    out = {"embed": {"table": next(it)}, "final_norm": {"scale": next(it)},
           "lm_head": next(it), "blocks": []}
    for l in range(dm.layers):
        blk = {"norm1": {"scale": next(it)}}
        if dm.kinds[l] == "attn":
            blk["attn"] = {k: next(it) for k in ("wq", "wk", "wv", "wo")}
        else:
            m = {k: next(it) for k in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                                       "dt_bias", "A_log", "D", "out_proj")}
            m.update({k: {"scale": next(it)} for k in ("dt_norm", "B_norm", "C_norm")})
            _mamba_init(m)
            blk["mamba"] = m
        blk["norm2"] = {"scale": next(it)}
        keys = ("router", "w_in", "w_out", "w_gate") if dm.moe[l] else ("w_in", "w_out",
                                                                         "w_gate")
        blk["ffn"] = {k: next(it) for k in keys}
        out["blocks"].append(blk)
    return out


def leaves(params: dict) -> list:
    """The leaves of a parameter tree in ``leaf_specs`` order."""
    out = [params["embed"]["table"], params["final_norm"]["scale"], params["lm_head"]]
    for b in params["blocks"]:
        out.append(b["norm1"]["scale"])
        if "attn" in b:
            out += [b["attn"][k] for k in ("wq", "wk", "wv", "wo")]
        else:
            m = b["mamba"]
            out += [m[k] for k in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                                   "dt_bias", "A_log", "D", "out_proj")]
            out += [m[k]["scale"] for k in ("dt_norm", "B_norm", "C_norm")]
        out.append(b["norm2"]["scale"])
        keys = ("router", "w_in", "w_out", "w_gate") if "router" in b["ffn"] else (
            "w_in", "w_out", "w_gate")
        out += [b["ffn"][k] for k in keys]
    return out


def loss(params, tokens, labels, dm, *, prec="fp32", remat=False):
    raise NotImplementedError("no training cell runs the Jamba form")


# -- a step's operations and least bytes (see lib/cost.py for what counts) ----
#
# Products only: the conv, the scan's elementwise updates and the norms are
# not counted as operations.  A decode step's least bytes count every
# expert of every MoE layer as read: at the cell's 32 rows, 64 routings a
# layer touch 16 (1 - (14/16)^32) = 15.8 of 16 experts on average; the
# MoE's own roofline (``moe_bytes``) counts the experts the traced steps
# routed to.


def mamba_params(dm: Dims) -> int:
    """One mixer's weights: in_proj, the conv's weight and bias, x_proj,
    dt_proj and its bias, A_log, D, out_proj and the three inner norms."""
    d, E, N, R, W = dm.d_model, dm.inner, dm.d_state, dm.dt_rank, dm.d_conv
    return (d * 2 * E + W * E + E + E * (R + 2 * N) + R * E + E + E * N + E + E * d
            + R + 2 * N)


def _mamba_products(dm: Dims) -> int:
    """One mixer's product weights (in_proj, x_proj, dt_proj, out_proj)."""
    d, E, N, R = dm.d_model, dm.inner, dm.d_state, dm.dt_rank
    return d * 2 * E + E * (R + 2 * N) + R * E + E * d


def _attn_params(dm: Dims) -> int:
    d, qd, kvd = dm.d_model, dm.heads * dm.head_dim, dm.kv_heads * dm.head_dim
    return d * qd + 2 * d * kvd + qd * d


def expert_params(dm: Dims) -> int:
    """One expert's SwiGLU (and one dense MLP's): three d x F products."""
    return 3 * dm.d_model * dm.d_ff


def _active_products(dm: Dims) -> int:
    """Product weights a token goes through: every mixer's, the dense MLPs',
    and at each MoE layer the router and K experts."""
    mixers = dm.attn_layers * _attn_params(dm) + dm.mamba_layers * _mamba_products(dm)
    dense = (dm.layers - dm.moe_layers) * expert_params(dm)
    moe = dm.moe_layers * (dm.top_k * expert_params(dm) + dm.d_model * dm.experts)
    return mixers + dense + moe


def _attention_flops(dm: Dims, batch: int, q_len: int, k_len: int) -> float:
    return (4.0 * batch * dm.heads * dm.head_dim * cost.causal_pairs(q_len, k_len)
            * dm.attn_layers)


def prefill_flops(dm: Dims, batch: int, length: int) -> float:
    """A prefill of ``batch`` prompts of ``length``: each token through its
    products, causal attention, the head at the last position."""
    return (2.0 * batch * length * _active_products(dm)
            + _attention_flops(dm, batch, length, length) + 2.0 * batch * dm.vocab * dm.d_model)


def decode_flops(dm: Dims, batch: int, position: int) -> float:
    """One decode step at ``position`` (0-based)."""
    return (2.0 * batch * (_active_products(dm) + dm.vocab * dm.d_model)
            + _attention_flops(dm, batch, 1, position + 1))


def train_flops(dm: Dims, batch: int, length: int) -> float:
    raise NotImplementedError("no training cell runs the Jamba form")


def mamba_state_bytes(dm: Dims, batch: int) -> int:
    """One mixer's states: the SSM state (B, E, N) and the conv's last W-1
    inputs (B, W-1, E)."""
    return batch * (dm.inner * dm.d_state + (dm.d_conv - 1) * dm.inner) * cost.F32


def decode_bytes(dm: Dims, batch: int, position: int) -> float:
    """Least bytes of one decode step: every weight read once, all experts
    of every MoE layer included (the embedding's rows of this step's tokens
    only), the attention layers' k/v of the ``position + 1`` filled
    positions read and this step's written, each mixer's states read and
    written."""
    d, F32 = dm.d_model, cost.F32
    moe = dm.moe_layers * (dm.experts * expert_params(dm) + d * dm.experts)
    weights = (dm.attn_layers * _attn_params(dm) + dm.mamba_layers * mamba_params(dm)
               + (dm.layers - dm.moe_layers) * expert_params(dm) + moe
               + dm.vocab * d + (2 * dm.layers + 1) * d) * F32
    kv_row = 2 * dm.kv_heads * dm.head_dim * F32 * dm.attn_layers
    states = 2 * dm.mamba_layers * mamba_state_bytes(dm, batch)
    return weights + batch * d * F32 + batch * (position + 2) * kv_row + states


def moe_bytes(dm: Dims, rows: int, experts: list) -> float:
    """Least bytes of a decode step's MoE layers: in each, the distinct
    experts routed to (``experts``, one count a layer) read once, the
    router read, the ``rows`` tokens in and out."""
    return float(sum(n * expert_params(dm) + dm.d_model * dm.experts + 2 * rows * dm.d_model
                     for n in experts) * cost.F32)


def mamba_bytes(dm: Dims, rows: int) -> float:
    """Least bytes of a decode step's mixers: each one's weights once, its
    states read and written once, its input and output rows."""
    one = mamba_params(dm) * cost.F32 + 2 * mamba_state_bytes(dm, rows) + 2 * rows * dm.d_model * cost.F32
    return float(dm.mamba_layers * one)
