"""Per-tenant serving isolation.

The pre-tenancy serving stack shared ONE tuning cache, ONE performance
model, and ONE set of drift windows across every tenant on the box.
That sharing contaminates statistics in both directions: tenant A's
drifted workload triggers a refinement that rewrites the cache entry and
refits the model tenant B is being served from, and B's perfectly
healthy samples dilute A's drift window so real drift fires late.  The
companion tuning work (Zhang et al., arXiv:1802.02760) evaluates
per-program configurations against per-program oracles, and Memeti &
Pllana (arXiv:2106.01441) show performance-aware scheduling must account
for co-running load — both argue for the same split implemented here:

  :class:`TenantContext`   one tenant's private serving state — a
      tuning-cache *namespace* (tenant-prefixed keys in the shared
      cache, so one persisted file still holds the fleet), its own
      :class:`~repro_torch.serving.refinement.DriftDetector` windows, and a
      lazily forked performance model;
  :class:`TenantRegistry`  resolves request tenant → context.  With
      ``isolate=False`` (the default everywhere) every tenant maps to
      one shared context with an empty namespace — byte-identical
      behavior, keys, and persisted caches to the pre-tenancy stack.

Model forking is copy-on-refit: all tenants serve from the shared
read-only base model until their first drift refinement, at which point
the refitting tenant gets a private fork
(:meth:`~repro_torch.core.perf_model.PerformanceModel.fork`) and only that
fork moves.  Models without a ``refit`` hook (e.g. the zero-training
heuristic) are never forked — there is no mutable state to isolate.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

from repro_torch.serving.refinement import DriftDetector


def fork_model(model):
    """Refit-isolated copy of ``model``; the model itself when it has no
    refit hook (immutable under serving, so sharing is safe)."""
    if not hasattr(model, "refit"):
        return model
    if hasattr(model, "fork"):
        return model.fork()
    import copy
    return copy.deepcopy(model)


@dataclasses.dataclass
class TenantContext:
    """One tenant's private serving state.

    ``namespace`` prefixes this tenant's tuning-cache keys (empty for
    the shared non-isolated context); ``drift`` holds this tenant's
    rolling per-bucket error windows; ``model`` is ``None`` until the
    first refinement needs to refit, then a private fork of
    ``base_model``."""

    name: str
    base_model: object
    drift: DriftDetector
    namespace: str = ""
    model: Optional[object] = None
    refinements: int = 0
    served: int = 0
    #: False only for the registry's shared non-isolated context: refits
    #: then land on ``base_model`` IN PLACE — the pre-tenancy contract,
    #: where the caller's model object receives every online refit
    isolated: bool = True

    @property
    def active_model(self):
        """The model this tenant's searches and refinements use: the
        shared base until the tenant has forked, its own fork after."""
        return self.model if self.model is not None else self.base_model

    @property
    def forked(self) -> bool:
        return self.model is not None

    def fork_for_refit(self):
        """Copy-on-refit: the first refit forks the base model so the
        tenant's measured feedback never leaks into other tenants (or
        the read-only base).  Idempotent.  The shared non-isolated
        context never forks — there is only one tenant population, and
        the caller handed us its model expecting in-place refits."""
        if not self.isolated:
            return self.base_model
        if self.model is None:
            forked = fork_model(self.base_model)
            # a model with no refit hook forks to itself — leave
            # ``model`` unset so ``forked`` stays honest
            if forked is not self.base_model:
                self.model = forked
        return self.active_model


class TenantRegistry:
    """Maps request tenants to :class:`TenantContext`\\ s.

    ``isolate=False``: one shared context (empty cache namespace, the
    scheduler's own drift detector) serves every tenant — the exact
    pre-tenancy behavior.  ``isolate=True``: each tenant lazily gets a
    context with its own namespace and a fresh clone of the drift
    detector template."""

    def __init__(self, base_model, shared_drift: DriftDetector, *,
                 isolate: bool = False):
        self.isolate = isolate
        self.base_model = base_model
        self._template = shared_drift
        self._shared = TenantContext("*", base_model, shared_drift,
                                     isolated=False)
        self._contexts: dict[str, TenantContext] = {}
        #: artifact id the base model was loaded from; None when the
        #: caller handed us a model object directly
        self.base_artifact_id: Optional[str] = None

    @classmethod
    def from_model_registry(cls, registry, shared_drift: DriftDetector, *,
                            spec: str = "latest", isolate: bool = False
                            ) -> "TenantRegistry":
        """Draw the shared read-only base model from a
        :class:`~repro_torch.core.modeling.registry.ModelRegistry` artifact —
        per-tenant copy-on-refit forks then descend from a real trained
        model, not a heuristic stand-in.  The loaded artifact id lands on
        ``.base_artifact_id`` so the caller can key caches / hot-swap
        polls off it."""
        model, manifest = registry.load(spec)
        reg = cls(model, shared_drift, isolate=isolate)
        reg.base_artifact_id = manifest.get("artifact_id")
        return reg

    def get(self, tenant: str) -> TenantContext:
        if not self.isolate:
            return self._shared
        ctx = self._contexts.get(tenant)
        if ctx is None:
            ctx = TenantContext(tenant, self.base_model,
                                self._template.clone(), namespace=tenant)
            self._contexts[tenant] = ctx
        return ctx

    def namespace(self, tenant: str) -> str:
        return tenant if self.isolate else ""

    # -- model lifecycle ------------------------------------------------------

    def hot_swap(self, base_model) -> int:
        """Swap the shared read-only base model (a newly published
        registry artifact).  Every context still serving from the base —
        including the shared non-isolated one — follows immediately;
        tenants that already forked keep their fork, whose measured
        online corrections are newer than any offline retrain.  Returns
        how many contexts now serve the new base."""
        self.base_model = base_model
        swapped = 0
        for ctx in [self._shared, *self._contexts.values()]:
            ctx.base_model = base_model
            if ctx.model is None:
                swapped += 1
        return swapped

    def persist_forks(self, model_registry, **meta) -> dict[str, str]:
        """Publish every tenant's refined fork back into a
        :class:`~repro_torch.core.modeling.registry.ModelRegistry` as a
        tenant-tagged artifact (never auto-pinned as ``latest``).
        Returns tenant name -> published artifact id.  A fork with no
        artifact serialization support is skipped — there is nothing
        durable to persist."""
        published: dict[str, str] = {}
        for ctx in self._contexts.values():
            if ctx.model is None or not hasattr(ctx.model, "to_state"):
                continue
            published[ctx.name] = model_registry.publish(
                ctx.model, tenant=ctx.name, **meta)
        return published

    @property
    def contexts(self) -> dict[str, TenantContext]:
        """Materialized per-tenant contexts (empty when not isolating)."""
        return dict(self._contexts)

    def __iter__(self) -> Iterator[TenantContext]:
        return iter(self._contexts.values())

    def __len__(self) -> int:
        return len(self._contexts)
