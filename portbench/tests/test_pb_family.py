"""The configuration's family (``lib/family.py``): what the Llama form's
cells read is what they read before it moved into ``families/llama.py``,
and a form of model that is not the Llama form runs as new files only."""
from __future__ import annotations

import hashlib
import json

import torch

from portbench.tests import tiny
from portbench.lib import cell, cost, family, readers, weights

# Taken from the harness before the Llama form moved into its family:
# the weights at tiny.config() for seed 2**33 + 5 (sha256 of the flat fp32
# buffer, and of the leaf names joined by newlines), and each step cost
# at the published sizes.
TINY_WEIGHTS = ("da2a362b1a3361663a0c67e3cb6799c65a37b8204311819f42e264f6f6c00107", 139584)
TINY_NAMES = "3d543fe495124656ebcbc09777dedf8273d13540832edb33ce936570b31f3d4f"
COSTS = {  # decode_bytes and decode_flops (32, 2504), prefill_flops (4, 4088),
           # train_flops (2, 2048), decode_bytes (16, 2504), decode_flops (16, 1920)
    "yi-9b": (50035965952, 611319808000.0, 297891453206528.0, 220439733338112.0,
              42152509440, 298311483392.0),
    "stablelm-3b": (63220951040, 196912087040.0, 93944081285120.0, 69652961034240.0,
                    36943472640, 95394201600.0),
}


def test_the_llama_forms_weights_have_not_moved():
    fam = family.of(tiny.config())
    dm = fam.dims(tiny.config())
    flat = torch.cat([x.reshape(-1) for x in fam.leaves(weights.make(fam, dm, 2**33 + 5, "cpu"))])
    assert (hashlib.sha256(flat.numpy().tobytes()).hexdigest(), flat.numel()) == TINY_WEIGHTS
    names = "\n".join(".".join(map(str, path)) for path, _, _, _ in fam.leaf_specs(dm)).encode()
    assert hashlib.sha256(names).hexdigest() == TINY_NAMES


def test_the_llama_forms_step_costs_have_not_moved():
    bench = cell.load_benchmark()
    for name, want in COSTS.items():
        cfg = cell.config(bench, name)
        fam = family.of(cfg)
        dm = fam.dims(cfg)
        got = (fam.decode_bytes(dm, 32, 2504), fam.decode_flops(dm, 32, 2504),
               fam.prefill_flops(dm, 4, 4088), fam.train_flops(dm, 2, 2048),
               fam.decode_bytes(dm, 16, 2504), fam.decode_flops(dm, 16, 1920))
        assert [repr(x) for x in got] == [repr(x) for x in want], name


# A decoder with a plain GELU MLP (two products) and multi-head attention,
# its sizes under GPT-NeoX's config keys: no ``rope_theta`` and no
# ``num_key_value_heads``, which the Llama form requires.
GELU_FAMILY = '''
"""Multi-head attention and a GELU MLP, GPT-NeoX's config keys."""
from __future__ import annotations

import dataclasses

import torch.nn.functional as F

from portbench.lib import cost
from portbench.reference import model as ref


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    layers: int
    d_model: int
    heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float

    kv_heads = property(lambda self: self.heads)
    group = property(lambda self: 1)
    attn_layers = property(lambda self: self.layers)


def dims(cfg):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return Dims(cfg["name"], cfg["num_hidden_layers"], d, h, d // h, cfg["intermediate_size"],
                cfg["vocab_size"], float(cfg["rotary_emb_base"]), float(cfg["layer_norm_eps"]))


def arch(dm, cfg):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name=dm.name, family="dense", num_layers=dm.layers, d_model=dm.d_model,
                      num_heads=dm.heads, num_kv_heads=dm.heads, d_ff=dm.d_ff,
                      vocab_size=dm.vocab, head_dim=dm.head_dim, rope_theta=dm.rope_theta,
                      norm_eps=dm.norm_eps, gated_mlp=False, tie_embeddings=False)


def leaf_specs(dm):
    d, H, hd, F_, V = dm.d_model, dm.heads, dm.head_dim, dm.d_ff, dm.vocab
    specs = [(("embed", "table"), (V, d), "normal", 1.0),
             (("final_norm", "scale"), (d,), "norm", 0.1),
             (("lm_head",), (V, d), "normal", d ** -0.5)]
    for l in range(dm.layers):
        b = ("blocks", l)
        specs += [(b + ("norm1", "scale"), (d,), "norm", 0.1)]
        specs += [(b + ("attn", k), (d, H, hd), "normal", d ** -0.5) for k in ("wq", "wk", "wv")]
        specs += [(b + ("attn", "wo"), (H, hd, d), "normal", (H * hd) ** -0.5),
                  (b + ("norm2", "scale"), (d,), "norm", 0.1),
                  (b + ("ffn", "w_in"), (d, F_), "normal", d ** -0.5),
                  (b + ("ffn", "w_out"), (F_, d), "normal", F_ ** -0.5)]
    return specs


def tree(dm, views):
    it = iter(views)
    out = {"embed": {"table": next(it)}, "final_norm": {"scale": next(it)},
           "lm_head": next(it), "blocks": []}
    for _ in range(dm.layers):
        out["blocks"].append({"norm1": {"scale": next(it)},
                              "attn": {k: next(it) for k in ("wq", "wk", "wv", "wo")},
                              "norm2": {"scale": next(it)},
                              "ffn": {k: next(it) for k in ("w_in", "w_out")}})
    return out


def leaves(params):
    out = [params["embed"]["table"], params["final_norm"]["scale"], params["lm_head"]]
    for b in params["blocks"]:
        out += [b["norm1"]["scale"]] + [b["attn"][k] for k in ("wq", "wk", "wv", "wo")]
        out += [b["norm2"]["scale"], b["ffn"]["w_in"], b["ffn"]["w_out"]]
    return out


def block(p, x, dm, prec):
    B, T, d = x.shape
    a = p["attn"]
    h = ref.rmsnorm(x, p["norm1"]["scale"], dm.norm_eps)
    q, k, v = (ref.mm(h, a[n].reshape(d, -1), prec).view(B, T, dm.heads, dm.head_dim)
               for n in ("wq", "wk", "wv"))
    o = ref.attention(ref.rope(q, dm.rope_theta), ref.rope(k, dm.rope_theta), v, dm, prec)
    x = x + ref.mm(o.reshape(B, T, -1), a["wo"].reshape(-1, d), prec)
    h = ref.rmsnorm(x, p["norm2"]["scale"], dm.norm_eps)
    f = p["ffn"]
    return x + ref.mm(F.gelu(ref.mm(h, f["w_in"], prec), approximate="tanh"), f["w_out"], prec)


def forward(params, tokens, dm, *, prec="fp32", logits_from=0, remat=False):
    x = params["embed"]["table"][tokens]
    for p in params["blocks"]:
        x = block(p, x, dm, prec)
    x = ref.rmsnorm(x[:, logits_from:], params["final_norm"]["scale"], dm.norm_eps)
    return ref.mm(x, params["lm_head"].T, prec)


def loss(params, tokens, labels, dm, *, prec="fp32", remat=False):
    logits = forward(params, tokens, dm, prec=prec)
    return F.cross_entropy(logits.reshape(-1, dm.vocab), labels.reshape(-1))


def _linear(dm):
    return dm.layers * (4 * dm.d_model * dm.d_model + 2 * dm.d_model * dm.d_ff)


def _attn(dm, batch, q_len, k_len):
    return 4.0 * batch * dm.d_model * cost.causal_pairs(q_len, k_len) * dm.layers


def prefill_flops(dm, batch, length):
    return (2.0 * batch * length * _linear(dm) + _attn(dm, batch, length, length)
            + 2.0 * batch * dm.vocab * dm.d_model)


def decode_flops(dm, batch, position):
    return (2.0 * batch * (_linear(dm) + dm.vocab * dm.d_model)
            + _attn(dm, batch, 1, position + 1))


def train_flops(dm, batch, length):
    return (6.0 * batch * length * (_linear(dm) + dm.vocab * dm.d_model)
            + 3.0 * _attn(dm, batch, length, length))


def decode_bytes(dm, batch, position):
    d = dm.d_model
    kv_row = 2 * d * cost.F32 * dm.layers
    return ((_linear(dm) + dm.vocab * d + (2 * dm.layers + 1) * d) * cost.F32
            + batch * d * cost.F32 + batch * (position + 2) * kv_row)
'''

GELU_CONFIG = {"name": "tiny-gelu", "source": "test", "family": "gelu_neox",
               "hidden_size": 64, "intermediate_size": 256, "num_hidden_layers": 2,
               "num_attention_heads": 4, "vocab_size": 512, "rotary_emb_base": 10000,
               "layer_norm_eps": 1e-5, "compute_dtype": "float32", "tf32": False}

GELU_DECODE = {"name": "tiny-gelu.decode", "config": "tiny-gelu", "driver": "serve",
               "batch": 3, "prompt_lengths": [12], "output_tokens": 20, "cache_positions": 48,
               "close_at": "step", "setup_boundaries": 2, "trace_boundaries": 2,
               "check": {"requests": 10**6, "limits": {"max_gap": 5e-4, "logit_err": 5e-4}}}


def test_a_form_that_is_not_the_llama_form_runs_as_new_files(tmp_path, monkeypatch):
    """A family module, a configuration file and a workload file, written
    in a directory of their own; only the family lookup points there."""
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "gelu_neox.py").write_text(GELU_FAMILY)
    (tmp_path / "tiny-gelu.json").write_text(json.dumps(GELU_CONFIG))
    (tmp_path / "tiny-gelu.decode.json").write_text(json.dumps(GELU_DECODE))
    monkeypatch.setattr(family, "DIR", tmp_path / "families")
    cfg = json.loads((tmp_path / "tiny-gelu.json").read_text())
    wl = json.loads((tmp_path / "tiny-gelu.decode.json").read_text())
    assert "rope_theta" not in cfg and "num_key_value_heads" not in cfg
    assert "gelu_neox" not in {p.stem for p in (cell.BENCH / "families").glob("*.py")}

    res, out = tiny.run(wl["name"], wl, cfg)
    assert res["correct"], res["checks"]
    assert res["metrics"]["setup_s"]["value"] > 0
    rec = out["record"]
    assert rec["family"] == "gelu_neox" and type(rec["dims"]).__name__ == "Dims"
    # the readers take the step's bytes from the record's family
    fam = family.load("gelu_neox")
    steps = [u for u in rec["units"] if u["kind"] == "decode" and "gap_s" in u]
    nbytes = sum(fam.decode_bytes(rec["dims"], u["rows"], u["position"]) for u in steps)
    want = 100.0 * nbytes / cost.HBM_BW / sum(u["gap_s"] for u in steps)
    assert readers.decode_bandwidth(rec) == want
    # and a broken product of the new form is caught
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "mlp_apply", lambda p, x, rules=None: x @ p["w_in"] @ p["w_out"])
    res, _ = tiny.run(wl["name"], wl, cfg)
    assert not res["correct"], res["checks"]
