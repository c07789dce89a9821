"""Back-compat shim: moved to :mod:`repro_torch.core.modeling.dataset`.

Note for monkeypatchers: rebinding names here (e.g. ``grid_for``) does
NOT affect the real call sites inside the modeling package — patch
``repro_torch.core.modeling.dataset`` instead."""
from repro_torch.core.modeling.dataset import (DEFAULT_CACHE, Sample,
                                               default_cache_path, generate,
                                               grid_for, loo_split,
                                               profile_sample,
                                               training_matrix)

__all__ = ["DEFAULT_CACHE", "default_cache_path", "Sample", "generate",
           "grid_for", "loo_split", "profile_sample", "training_matrix"]
