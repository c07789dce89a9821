"""Back-compat shim: moved to :mod:`repro_torch.core.modeling.search`."""
from repro_torch.core.modeling.search import (search_best,
                                              search_best_batch,
                                              simulated_annealing)

__all__ = ["search_best", "search_best_batch", "simulated_annealing"]
