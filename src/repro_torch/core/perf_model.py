"""Back-compat shim: the model code moved to
:mod:`repro_torch.core.modeling` (perf_model / pipeline / learners).
Import from there; this module re-exports the public names so existing
callers keep working."""
from repro_torch.core.modeling.base import assemble_rows
from repro_torch.core.modeling.learners import (ForestRegressor,
                                                KernelRidgeRBF,
                                                TreeRegressor)
from repro_torch.core.modeling.perf_model import (FeaturePipeline,
                                                  PerformanceModel)

__all__ = ["FeaturePipeline", "PerformanceModel", "TreeRegressor",
           "ForestRegressor", "KernelRidgeRBF", "assemble_rows"]
