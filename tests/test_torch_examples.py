"""The port's examples (``examples/torch/``) on the CPU: each exits 0, keeps
its own asserts, and prints the lines of the JAX package's example of the
same name (the same headings, the same fields); without ``--device cpu``
each refuses to run here.  (``tests/test_torch_serve.py`` holds their
sources, with the package's, to importing neither jax nor repro.)

``serve_batched`` and ``fault_tolerant_train`` run whole, as a user runs
them, with ``--device cpu`` in a child process.  ``quickstart`` and
``autotune_workloads`` profile workloads over the stream-config grid;
they run through their ``main(...)`` with a 4 x 8 grid in place of the
32 x 64 one (as ``tests/conftest.py`` shrinks the JAX package's), on 3
programs at 1-2 datasets, 1 rep, and fewer training epochs.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
REFERENCE = ROOT / "examples"
NAMES = ("quickstart", "serve_batched", "autotune_workloads", "fault_tolerant_train")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _run(name: str) -> str:
    proc = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"), "--device", "cpu"],
                          capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_headings(name: str) -> list:
    """The ``=== ... ===`` headings the JAX example prints, as patterns (an
    f-string field matches any text)."""
    src = (REFERENCE / f"{name}.py").read_text()
    heads = re.findall(r'"(?:\\n)?(=== .*? ===)"', src)
    assert heads, name
    return [re.escape(h).replace(r"\{", "{").replace(r"\}", "}") for h in heads]


def _has_reference_lines(out: str, name: str, extra: list):
    for pat in _reference_headings(name) + extra:
        pat = re.sub(r"\{[^}]*\}", ".+?", pat)
        assert re.search(pat, out, re.M), (pat, out[-3000:])


@pytest.fixture
def small_grid(monkeypatch):
    from repro_torch.core.modeling import dataset

    orig = dataset.grid_for
    monkeypatch.setattr(dataset, "grid_for", lambda n_rows, max_partitions=4, max_tasks=8:
                        orig(n_rows, max_partitions, max_tasks))


def test_serve_batched_runs_on_the_cpu():
    out = _run("serve_batched")
    _has_reference_lines(out, "serve_batched", [
        r"^\d+ tokens in [\d.]+s \(\d+ tok/s\)$",
        r"^(vecadd|dotprod|mvmult)\s+config=\d+x\d+\s+cold=\s*[\d.]+ms\s+warm=\s*[\d.]+us"
        r"\s+\(\s*\d+x faster\)$",
        r"^cache: 3 hits / 3 misses \(3 entries\)$"])
    assert len(re.findall(r"tokens in", out)) == 2
    assert len(re.findall(r"config=", out)) == 3


def test_fault_tolerant_train_resumes_on_the_cpu():
    out = _run("fault_tolerant_train")
    _has_reference_lines(out, "fault_tolerant_train", [
        r"^checkpoints -> .+$",
        r"^resumed from step 9; ran only 14 remaining steps; final loss [\d.]+$"])
    ckpt = re.search(r"^checkpoints -> (.+)$", out, re.M).group(1)
    assert Path(ckpt).parent == ROOT / "build" and not os.path.exists(ckpt)


def test_quickstart_trains_tunes_and_warm_starts_on_the_cpu(small_grid, tmp_path, capsys):
    qs = _load("quickstart")
    res, cold, warm = qs.main("cpu", programs=("vecadd", "jacobi-1d", "blackscholes"),
                              datasets_per_program=1, epochs=50, cache_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert res.steps_run == 30 and res.final_loss == res.final_loss
    assert not cold.cached and warm.cached and warm.config == cold.config
    _has_reference_lines(out, "quickstart", [
        r"^loss [\d.]+ -> [\d.]+$",
        r"^chosen stream config for dotprod: \(partitions=\d+, tasks=\d+\)$",
        r"^predicted speedup [\d.]+x; search took [\d.]+ ms \(feature extraction \d+ ms\)$",
        r"^warm hit: cached=True, same config=True, \d+ ms cold -> \d+ us warm"])
    assert (tmp_path / "quickstart_tuning_cache.json").exists()
    # a second run warm-starts from the persisted file
    qs.main("cpu", programs=("vecadd", "jacobi-1d", "blackscholes"),
            datasets_per_program=1, epochs=50, cache_dir=str(tmp_path))
    assert "cache file from a previous run served both tunes" in capsys.readouterr().out


def test_autotune_workloads_runs_leave_one_out_on_the_cpu(small_grid, tmp_path, capsys):
    at = _load("autotune_workloads")
    programs = ["vecadd", "dotprod", "jacobi-1d"]
    achieved, oracle = at.main("cpu", programs=programs, datasets_per_program=2, reps=1,
                               epochs=100, cache_path=str(tmp_path / "profile.json"))
    out = capsys.readouterr().out
    assert len(achieved) == len(oracle) == 6
    assert all(0 < a <= o + 1e-9 for a, o in zip(achieved, oracle))
    rows = re.findall(r"^(\S+)@\d+\s+[\d.]+x\s+[\d.]+x\s+[\d.]+%$", out, re.M)
    assert sorted(set(rows)) == sorted(programs) and len(rows) == 6
    assert re.search(r"^program\s+achieved\s+oracle\s+% of oracle$", out, re.M)
    assert re.search(r"^GEOMEAN achieved [\d.]+x, oracle [\d.]+x -> [\d.]+% of oracle "
                     r"\(paper: 93\.7% XeonPhi / 97\.9% GPU\)$", out, re.M)


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_to_run_on_the_cpu_quietly(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the example would run on the card")
    proc = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py")], capture_output=True,
                          text=True, env=_env(), timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
