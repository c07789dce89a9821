"""The :class:`ModelRegistry`: an artifact directory with ``latest``
pinning and hot-swap — where offline training publishes and serving
loads.

Layout under the registry root (``REPRO_TORCH_MODEL_DIR`` or
``<repo>/build/models``, apart from the JAX package's ``<repo>/models`` so
an artifact trained there is never picked up here by accident)::

    models/
      latest                     <- text file naming the pinned artifact
      mlp-v001/                  <- fleet-wide artifact
        manifest.json
        weights.npz
      mlp-tenant-a-v001/         <- tenant-tagged fork (never auto-pinned)
        ...

``publish`` allocates the next version for the (kind, tenant) lineage,
writes the artifact, and — for fleet-wide (non-tenant) artifacts —
repoints ``latest``.  ``load("latest")`` follows the pointer;
``refresh(current_id)`` is the serving hot-swap hook: it reloads only
when the pointer has moved since the caller last loaded.
"""
from __future__ import annotations

import errno
import os
import re
import shutil
import warnings
from pathlib import Path
from typing import Optional

from repro_torch.core import REPO_ROOT
from repro_torch.core.modeling.artifacts import (is_artifact_dir,
                                                 load_artifact,
                                                 read_manifest,
                                                 save_artifact)

LATEST_NAME = "latest"


def default_model_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_MODEL_DIR")
    return Path(env) if env else (REPO_ROOT / "build" / "models")


class ModelRegistry:
    def __init__(self, root: "str | Path | None" = None, *, metrics=None):
        self.root = Path(root) if root else default_model_dir()
        # duck-typed MetricsRegistry (kept optional so core never
        # imports serving): counts dangling-latest fallbacks
        self.metrics = metrics

    # -- enumeration ---------------------------------------------------------

    def list(self) -> list[str]:
        """Artifact ids present in the registry, sorted.  Hidden
        ``.stage-*`` directories (in-flight publishes, or orphans from a
        publisher that crashed mid-stage) are not artifacts."""
        if not self.root.is_dir():
            return []
        return sorted(p.name for p in self.root.iterdir()
                      if p.is_dir() and not p.name.startswith(".")
                      and is_artifact_dir(p))

    def _fallback_for(self, dangling_id: str) -> Optional[str]:
        """Newest resolvable artifact to stand in for a dangling
        ``latest`` pointer: same lineage as the dangling id when any
        version of it survives, else the lexically-newest artifact
        overall (zero-padded ``v%03d`` makes lexical order = version
        order).  None when the registry holds nothing resolvable."""
        known = self.list()
        if not known:
            return None
        stem = re.sub(r"-v\d+$", "", dangling_id)
        same_lineage = [a for a in known
                        if re.fullmatch(re.escape(stem) + r"-v\d+", a)]
        return max(same_lineage) if same_lineage else max(known)

    def _next_version(self, kind: str, tenant: str) -> int:
        stem = "-".join(filter(None, [kind, tenant]))
        pat = re.compile(re.escape(stem) + r"-v(\d+)$")
        versions = [int(m.group(1)) for name in self.list()
                    if (m := pat.match(name))]
        return max(versions, default=0) + 1

    # -- publish / pin -------------------------------------------------------

    def publish(self, model, *, corpus: str = "", cv: Optional[dict] = None,
                tag: str = "", tenant: str = "",
                pin_latest: Optional[bool] = None) -> str:
        """Write ``model`` as the next artifact version of its (kind,
        tenant) lineage; fleet-wide publishes repoint ``latest`` unless
        ``pin_latest=False``.  Tenant-tagged artifacts (refined serving
        forks persisted back) never auto-pin: a single tenant's drift
        correction must not become the fleet default.

        Concurrency-safe: the artifact is staged into a hidden temp
        directory and renamed into place, so a reader never sees a
        half-written weights file, and two publishers racing for the
        same version number collide on the rename — the loser
        re-allocates the next version instead of overwriting."""
        self.root.mkdir(parents=True, exist_ok=True)
        stage = self.root / f".stage-{os.getpid()}-{id(model):x}"
        save_artifact(model, stage, corpus=corpus, cv=cv, tag=tag,
                      tenant=tenant)
        try:
            last_err = None
            for _ in range(50):
                artifact_id = "-".join(filter(None, [
                    model.kind, tenant,
                    f"v{self._next_version(model.kind, tenant):03d}"]))
                try:
                    stage.rename(self.root / artifact_id)
                    break
                except OSError as e:
                    # only an exists-collision means a concurrent
                    # publisher won this version number; anything else
                    # (EACCES, EXDEV, ...) is a real failure
                    if e.errno not in (errno.EEXIST, errno.ENOTEMPTY):
                        raise
                    last_err = e
            else:
                raise RuntimeError(
                    f"could not allocate an artifact version under "
                    f"{self.root} after 50 attempts") from last_err
        finally:
            if stage.exists():
                shutil.rmtree(stage, ignore_errors=True)
        if pin_latest if pin_latest is not None else not tenant:
            self.pin(artifact_id)
        return artifact_id

    def pin(self, artifact_id: str) -> None:
        """Atomically repoint ``latest`` (the hot-swap publication).
        The temp name is per-process: concurrent publishers must not
        clobber (or delete) each other's staging file mid-replace."""
        if not is_artifact_dir(self.root / artifact_id):
            raise FileNotFoundError(
                f"cannot pin {artifact_id!r}: no artifact at "
                f"{self.root / artifact_id}")
        tmp = self.root / f".{LATEST_NAME}.tmp-{os.getpid()}"
        tmp.write_text(artifact_id + "\n")
        tmp.replace(self.root / LATEST_NAME)

    def latest_id(self) -> Optional[str]:
        ptr = self.root / LATEST_NAME
        if not ptr.exists():
            return None
        artifact_id = ptr.read_text().strip()
        return artifact_id or None

    # -- resolve / load ------------------------------------------------------

    def resolve(self, spec: str = "latest") -> Path:
        """``spec`` is ``"latest"``, an artifact id, or a filesystem path
        to an artifact directory."""
        if spec == "latest":
            artifact_id = self.latest_id()
            if artifact_id is None:
                raise FileNotFoundError(
                    f"registry {self.root} has no 'latest' artifact "
                    f"(publish one with launch/train_model.py)")
            path = self.root / artifact_id
            if not is_artifact_dir(path):
                # dangling pointer = registry corruption.  With other
                # resolvable versions present, serving falls back to the
                # newest one (same lineage preferred) with a warning —
                # a deleted artifact must not take the fleet down.  With
                # NOTHING resolvable left this stays a hard RuntimeError
                # (NOT FileNotFoundError: the empty-registry bootstrap
                # must not silently paper over corruption with a fresh
                # model).
                fallback = self._fallback_for(artifact_id)
                if fallback is None:
                    raise RuntimeError(
                        f"registry {self.root}: 'latest' points at "
                        f"{artifact_id!r} but no artifact exists there")
                warnings.warn(
                    f"registry {self.root}: 'latest' points at "
                    f"{artifact_id!r} which no longer exists; falling "
                    f"back to newest resolvable version {fallback!r}")
                if self.metrics is not None:
                    self.metrics.counter(
                        "serving.registry.latest_fallback").inc()
                return self.root / fallback
            return path
        if is_artifact_dir(self.root / spec):
            return self.root / spec
        if is_artifact_dir(spec):
            return Path(spec)
        raise FileNotFoundError(
            f"no artifact {spec!r} in registry {self.root} "
            f"(known: {self.list() or 'none'})")

    def load(self, spec: str = "latest"):
        """Load ``(model, manifest)``; the manifest gains an
        ``artifact_id`` field naming what was actually resolved."""
        path = self.resolve(spec)
        model, manifest = load_artifact(path)
        manifest["artifact_id"] = path.name
        return model, manifest

    def manifest(self, spec: str = "latest") -> dict:
        path = self.resolve(spec)
        manifest = read_manifest(path)
        manifest["artifact_id"] = path.name
        return manifest

    def refresh(self, current_id: Optional[str]):
        """Hot-swap poll: when ``latest`` points somewhere new, load and
        return ``(model, manifest)``; ``None`` while unchanged.  This is
        the serving driver's hook — a long-lived deployment polls it
        between traces and feeds a non-``None`` result to
        :meth:`AdaptiveScheduler.swap_model`; the shipped one-trace CLI
        (``serve.py --adaptive``) instead picks up the new ``latest`` on
        its next launch."""
        latest = self.latest_id()
        if latest is None or latest == current_id:
            return None
        return self.load(latest)
