"""Offline performance-model training CLI — the "at the factory" half of
the paper's train-offline / predict-at-runtime split (§3.1).

    PYTHONPATH=src python -m repro_torch.launch.train_model \
        [--programs a,b,c] [--datasets N] [--kind mlp] [--epochs 600] \
        [--model-dir build/models/] [--tag nightly] [--no-cv] \
        [--device cuda]

Pipeline: profile the workload corpus (every (program, dataset,
stream-config) cell, reusing — and extending — the persistent profile
cache), assemble the (features ++ config) -> speedup training matrix,
leave-one-program-out cross-validate (§5.3.1), train on the full corpus,
and publish the artifact into the :class:`ModelRegistry`, which repoints
``latest``.  Profiling and the MLP run on ``--device`` (the card unless
``--device cpu`` is given; without CUDA the default raises).

The published manifest is stamped with the feature-schema hash, the
corpus fingerprint, and the CV score, so a serving box can tell exactly
what it is running and a schema drift refuses to load at all.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

from repro_torch.core.modeling import dataset as ds
from repro_torch.core.modeling.artifacts import corpus_fingerprint
from repro_torch.core.modeling.evaluate import loo_evaluate
from repro_torch.core.modeling.learners import (ForestRegressor,
                                                KernelRidgeRBF,
                                                TreeRegressor)
from repro_torch.core.modeling.perf_model import PerformanceModel
from repro_torch.core.modeling.registry import ModelRegistry
from repro_torch.device import resolve_device

#: a compact mixed corpus: transfer-bound, compute-bound, and in-between
#: programs so leave-one-out folds always train on both regimes
DEFAULT_TRAIN_PROGRAMS = ("vecadd", "dotprod", "mvmult", "binomial",
                          "blackscholes", "jacobi-1d")

#: the small corpus serving bootstraps from when no artifact exists yet:
#: exactly the default adaptive-serving workloads
BOOTSTRAP_PROGRAMS = ("vecadd", "dotprod", "mvmult")

TRAINERS = {
    "mlp": PerformanceModel,
    "cart": TreeRegressor,
    "forest": ForestRegressor,
    "krr": KernelRidgeRBF,
}


def _train_kwargs(kind: str, *, epochs: int, n_components: int,
                  seed: int, device) -> dict:
    kw = {"n_components": n_components, "seed": seed}
    if kind == "mlp":
        kw["epochs"] = epochs
        kw["device"] = device
    return kw


def train_and_publish(
    programs: Optional[Sequence[str]] = None,
    *,
    kind: str = "mlp",
    datasets_per_program: int = 2,
    reps: int = 1,
    epochs: int = 600,
    n_components: int = 9,
    seed: int = 0,
    cache_path=None,
    registry: Optional[ModelRegistry] = None,
    model_dir=None,
    tag: str = "",
    run_cv: bool = True,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Profile -> (CV) -> train -> publish on ``device``; returns the run
    summary."""
    cls = TRAINERS[kind]
    programs = list(programs or DEFAULT_TRAIN_PROGRAMS)
    registry = registry or ModelRegistry(model_dir)
    device = resolve_device(device)
    kw = _train_kwargs(kind, epochs=epochs, n_components=n_components,
                       seed=seed, device=device)

    t0 = time.perf_counter()
    samples = ds.generate(programs, datasets_per_program=datasets_per_program,
                          reps=reps, cache_path=cache_path, verbose=verbose,
                          device=device)
    t_profile = time.perf_counter() - t0
    corpus = corpus_fingerprint(samples)

    cv = None
    t_cv = 0.0
    if run_cv:
        t0 = time.perf_counter()
        cv = loo_evaluate(samples, model_cls=cls, train_kwargs=kw,
                          verbose=verbose)
        t_cv = time.perf_counter() - t0

    t0 = time.perf_counter()
    X, y = ds.training_matrix(samples)
    model = cls.train(X, y, **kw)
    t_train = time.perf_counter() - t0

    artifact_id = registry.publish(model, corpus=corpus, cv=cv, tag=tag)
    summary = {
        "artifact_id": artifact_id,
        "registry": str(registry.root),
        "kind": kind,
        "device": str(device),
        "programs": programs,
        "n_samples": len(samples),
        "n_rows": int(X.shape[0]),
        "corpus_fingerprint": corpus,
        "cv": cv,
        "profile_s": t_profile,
        "cv_s": t_cv,
        "train_s": t_train,
    }
    if verbose:
        frac = cv["frac_of_oracle"] if cv else None
        print(f"published {artifact_id} -> {registry.root} "
              f"(rows={X.shape[0]}, corpus={corpus}"
              + (f", loo_frac_of_oracle={frac:.3f}" if frac else "")
              + ")", file=sys.stderr, flush=True)
    return summary


def bootstrap_artifact(registry: ModelRegistry, *, verbose: bool = True,
                       epochs: int = 400, device="cuda") -> str:
    """Train-and-publish a minimal artifact on ``device`` when the
    registry is empty — the zero-to-serving path.  Uses the default
    adaptive-serving workloads at two dataset scales each; the profile
    cache makes every run after the first take seconds, not minutes."""
    if verbose:
        print("model registry is empty — bootstrapping a trained "
              "artifact (profiling the bootstrap corpus; cached for "
              "next time)...", file=sys.stderr, flush=True)
    summary = train_and_publish(
        BOOTSTRAP_PROGRAMS, kind="mlp", datasets_per_program=2, reps=1,
        epochs=epochs, registry=registry, tag="bootstrap",
        run_cv=True, verbose=verbose, device=device)
    return summary["artifact_id"]


def main() -> None:
    ap = argparse.ArgumentParser(
        description="profile the corpus, train a performance model, "
                    "cross-validate leave-one-program-out, publish the "
                    "artifact")
    ap.add_argument("--programs", default=None,
                    help="comma-separated workload names "
                         f"(default: {','.join(DEFAULT_TRAIN_PROGRAMS)})")
    ap.add_argument("--datasets", type=int, default=2,
                    help="dataset scales per program")
    ap.add_argument("--reps", type=int, default=1,
                    help="profiling repetitions per grid cell")
    ap.add_argument("--kind", default="mlp", choices=sorted(TRAINERS),
                    help="estimator kind to train")
    ap.add_argument("--epochs", type=int, default=600,
                    help="MLP training epochs (mlp kind only)")
    ap.add_argument("--n-components", type=int, default=9,
                    help="PCA components in the feature pipeline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-cache", default=None,
                    help="profile cache path (default: "
                         "REPRO_TORCH_PROFILE_CACHE or "
                         "<repo>/build/profile_cache_<device type>.json)")
    ap.add_argument("--model-dir", default=None,
                    help="registry root (default: REPRO_TORCH_MODEL_DIR or "
                         "<repo>/build/models)")
    ap.add_argument("--tag", default="", help="free-form artifact tag")
    ap.add_argument("--no-cv", action="store_true",
                    help="skip leave-one-program-out cross-validation")
    ap.add_argument("--device", default="cuda",
                    help="device to profile and train on (cuda or cpu)")
    args = ap.parse_args()

    summary = train_and_publish(
        args.programs.split(",") if args.programs else None,
        kind=args.kind, datasets_per_program=args.datasets,
        reps=args.reps, epochs=args.epochs,
        n_components=args.n_components, seed=args.seed,
        cache_path=args.profile_cache, model_dir=args.model_dir,
        tag=args.tag, run_cv=not args.no_cv, device=args.device)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
