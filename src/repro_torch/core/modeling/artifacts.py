"""Versioned model artifacts: the train-at-the-factory / predict-in-
production split's on-disk contract.

An artifact is a directory holding

  ``manifest.json``   kind, format version, feature-schema hash,
                      training-corpus fingerprint, leave-one-program-out
                      CV score, optional tag/tenant provenance, plus the
                      estimator's JSON-safe extras;
  ``weights.npz``     every numpy array of the estimator (feature
                      pipeline + learner parameters), bit-exact.

Loading refuses a manifest whose feature-schema hash does not match the
running code's (:class:`SchemaMismatchError`): a model trained against a
different feature vector would silently mis-rank every config — the one
failure mode a serving fleet cannot detect from telemetry alone, because
the predictions stay plausible.
"""
from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.features import N_CONFIG_FEATURES, RAW_FEATURE_NAMES
from repro_torch.core.modeling.base import get_estimator_kind

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.npz"


class SchemaMismatchError(RuntimeError):
    """The artifact was trained against a different feature schema than
    the running code extracts — refusing to serve from it."""


def feature_schema_hash() -> str:
    """Hash of the feature vector the running code produces: the raw
    feature names (order included) ++ the config-encoding width.  Any
    change to either invalidates every existing artifact."""
    payload = json.dumps({"raw_features": RAW_FEATURE_NAMES,
                          "n_config_features": N_CONFIG_FEATURES},
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def corpus_fingerprint(samples: Sequence) -> str:
    """Order-independent digest of a profiled training corpus: which
    (program, dataset) cells it covers and how densely each was swept.
    Stamped into the manifest (and used as the CI profile-cache key
    material) so 'same corpus' is checkable without re-profiling."""
    h = hashlib.sha256()
    for s in sorted(samples, key=lambda s: (s.program, s.scale)):
        cfgs = ",".join(f"{p}x{t}" for p, t in sorted(s.times))
        h.update(f"{s.program}@{s.scale}:[{cfgs}];".encode())
    return h.hexdigest()[:16]


def save_artifact(model, path: "str | Path", *,
                  corpus: str = "",
                  cv: Optional[dict] = None,
                  tag: str = "",
                  tenant: str = "",
                  extra_meta: Optional[dict] = None) -> Path:
    """Write ``model`` as a versioned artifact directory at ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays, extras = model.to_state()
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": model.kind,
        "feature_schema_hash": feature_schema_hash(),
        "corpus_fingerprint": corpus,
        "cv": cv,
        "tag": tag,
        "tenant": tenant,
        "created_unix": time.time(),
        "extras": extras,
    }
    if extra_meta:
        # namespaced: free-form metadata must not clobber the reserved
        # keys (kind, feature_schema_hash, ...) the loader dispatches on
        manifest["extra"] = dict(extra_meta)
    np.savez(path / WEIGHTS_NAME, **arrays)
    tmp = path / (MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    tmp.replace(path / MANIFEST_NAME)
    return path


def read_manifest(path: "str | Path") -> dict:
    with open(Path(path) / MANIFEST_NAME) as f:
        return json.load(f)


def is_artifact_dir(path: "str | Path") -> bool:
    return (Path(path) / MANIFEST_NAME).exists()


def load_artifact(path: "str | Path", *,
                  allow_schema_mismatch: bool = False):
    """Load ``(model, manifest)`` from an artifact directory.

    Raises :class:`SchemaMismatchError` when the artifact's feature
    schema hash differs from the running code's (override only for
    forensics — a mismatched model mis-ranks every config)."""
    path = Path(path)
    manifest = read_manifest(path)
    version = int(manifest.get("format_version", -1))
    if version > FORMAT_VERSION:
        raise RuntimeError(
            f"artifact {path} has format_version {version}, newer than "
            f"this code's {FORMAT_VERSION} — upgrade before loading")
    want = feature_schema_hash()
    got = manifest.get("feature_schema_hash")
    if got != want and not allow_schema_mismatch:
        raise SchemaMismatchError(
            f"artifact {path} was trained against feature schema {got}, "
            f"but the running code extracts schema {want}; retrain (or "
            f"pass allow_schema_mismatch=True for forensics)")
    cls = get_estimator_kind(manifest["kind"])
    with np.load(path / WEIGHTS_NAME) as npz:
        arrays = {k: npz[k] for k in npz.files}
    model = cls.from_state(arrays, manifest.get("extras", {}))
    return model, manifest
