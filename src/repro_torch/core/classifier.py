"""Back-compat shim: moved to :mod:`repro_torch.core.modeling.classifier`."""
from repro_torch.core.modeling.classifier import KNNClassifier, merge_labels

__all__ = ["KNNClassifier", "merge_labels"]
