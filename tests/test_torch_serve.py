"""Port ``serve`` against the JAX ``serve``, and the port's isolation.

``serve`` on the CPU (plain kernel versions), fed the JAX weights, must
generate exactly the JAX ``serve``'s greedy tokens.  The port must import
neither ``jax`` nor anything of ``repro``, and must refuse to run on a
machine without CUDA unless asked for the CPU.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.launch.serve import serve as jax_serve
from repro.models.model_zoo import Model as JaxModel
from repro.models.transformer import RunConfig as JaxRunConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMALL = dict(n_requests=5, batch_slots=2, prompt_len=8, gen_len=4, reduced=True,
             seed=0, verbose=False)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _jax_params(seed=0, arch="yi-9b"):
    m = JaxModel(jax_get_arch(arch).reduced(), JaxRunConfig())
    params, _ = m.init(jax.random.key(seed))
    return jax.tree.map(np.asarray, jax.device_get(params))


def test_serve_generates_the_jax_tokens():
    want = jax_serve("yi-9b", **SMALL)
    ops.reset_launch_counts()
    got = serve("yi-9b", device="cpu", params=params_from_jax(_jax_params()), **SMALL)
    assert len(got.outputs) == len(want.outputs) == 5  # ragged last batch of 1
    for g, w in zip(got.outputs, want.outputs):
        assert g.dtype == np.int32 and g.shape == (4,)
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.tokens_generated == want.tokens_generated == 20
    assert got.logits_finite and 0 <= got.prefill_s <= got.wall_s
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "rmsnorm": 0, "rmsnorm_bwd": 0, "decode_attention": 0,
                                   "decode_proj": 0}


def test_stablelm_serve_generates_the_jax_tokens():
    # stablelm-3b is the config the card serves at head dim 80.
    want = jax_serve("stablelm-3b", **SMALL)
    got = serve("stablelm-3b", device="cpu",
                params=params_from_jax(_jax_params(arch="stablelm-3b")), **SMALL)
    assert len(got.outputs) == len(want.outputs) == 5
    for g, w in zip(got.outputs, want.outputs):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_recurrent_serve_generates_the_jax_tokens(arch):
    # the recurrent layers hand their prefill state to decode whole
    want = jax_serve(arch, **SMALL)
    got = serve(arch, device="cpu", params=params_from_jax(_jax_params(arch=arch)), **SMALL)
    assert len(got.outputs) == len(want.outputs) == 5
    for g, w in zip(got.outputs, want.outputs):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.logits_finite


def test_serve_is_deterministic_in_its_seed():
    a = serve("yi-9b", device="cpu", **SMALL)
    b = serve("yi-9b", device="cpu", **SMALL)
    for x, y in zip(a.outputs, b.outputs):
        np.testing.assert_array_equal(x, y)


def test_serve_rejects_sampling():
    with pytest.raises(NotImplementedError):
        serve("yi-9b", device="cpu", greedy=False, **SMALL)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve("yi-9b", **SMALL)


def test_cli_refuses_to_run_on_the_cpu_quietly():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the CLI would serve on the card")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-9b",
         "--requests", "1", "--prompt-len", "4", "--gen-len", "2"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "tok/s" not in proc.stdout


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.launch.serve, repro_torch.weights, "
            "repro_torch.kernels.ops, repro_torch.serving, repro_torch.core.autotuner, "
            "repro_torch.launch.train_model, repro_torch.serving.fleet, "
            "repro_torch.serving.traces, repro_torch.launch.stats, "
            "repro_torch.core.analytical, repro_torch.core.classifier, "
            "repro_torch.core.dataset, repro_torch.core.perf_model, "
            "repro_torch.core.search, repro_torch.parallel.sharding_rules, "
            "repro_torch.launch.mesh, repro_torch.launch.elastic; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + sorted(str(p.relative_to(ROOT))
                                  for p in (ROOT / "examples" / "torch").glob("*.py"))
                         + ["chip_smoke.py"])
def test_source_imports_neither_jax_nor_repro(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text()), path


def test_chip_smoke_refuses_without_cuda_or_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: chip_smoke.py would run in full")
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                              text=True, cwd=where, timeout=120,
                              env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
