"""The offline-trained model lifecycle in one package (paper §3).

  base        the :class:`Estimator` protocol + kind registry
  pipeline    Z-score -> correlation pruning -> PCA feature front end
  perf_model  the MLP regression model (ours, torch), with online ``refit``
  learners    CART / random forest / RBF kernel ridge (Table 5)
  heuristic   the zero-training overlap bound (explicit fallback only)
  classifier  the classification-based prior-work baseline (§6.4)
  search      model-driven config ranking + the SA baseline (§3.3, §2.3)
  dataset     corpus profiling, the profile cache, LOO splits (§3.1.1)
  evaluate    leave-one-program-out CV scoring (§5.3.1)
  artifacts   versioned save/load: manifest.json + weights.npz, schema-
              hash guarded (the JAX package's format, readable both ways)
  registry    artifact directory with ``latest`` pinning and hot-swap

Train at the factory (``launch/train_model.py`` publishes into the
registry).
"""
from repro_torch.core.modeling.artifacts import (SchemaMismatchError,
                                                 corpus_fingerprint,
                                                 feature_schema_hash,
                                                 load_artifact, save_artifact)
from repro_torch.core.modeling.base import (ESTIMATOR_KINDS, Estimator,
                                            EstimatorBase, assemble_rows,
                                            get_estimator_kind,
                                            register_estimator)
from repro_torch.core.modeling.classifier import (KNNClassifier,
                                                  merge_labels)
from repro_torch.core.modeling.evaluate import (evaluate_model, geomean,
                                                loo_evaluate)
from repro_torch.core.modeling.heuristic import OverlapHeuristicModel
from repro_torch.core.modeling.learners import (ForestRegressor,
                                                KernelRidgeRBF,
                                                TreeRegressor)
from repro_torch.core.modeling.perf_model import (FeaturePipeline,
                                                  PerformanceModel)
from repro_torch.core.modeling.registry import (ModelRegistry,
                                                default_model_dir)
from repro_torch.core.modeling.search import (search_best,
                                              search_best_batch,
                                              simulated_annealing)

__all__ = [
    "Estimator", "EstimatorBase", "ESTIMATOR_KINDS", "assemble_rows",
    "register_estimator", "get_estimator_kind",
    "FeaturePipeline", "PerformanceModel",
    "TreeRegressor", "ForestRegressor", "KernelRidgeRBF",
    "OverlapHeuristicModel",
    "KNNClassifier", "merge_labels",
    "search_best", "search_best_batch", "simulated_annealing",
    "evaluate_model", "loo_evaluate", "geomean",
    "SchemaMismatchError", "save_artifact", "load_artifact",
    "feature_schema_hash", "corpus_fingerprint",
    "ModelRegistry", "default_model_dir",
]
