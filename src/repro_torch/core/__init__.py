"""The streamed-autotuning system of the port: workloads, the runner and
its backends, features and the learnt performance model."""
from pathlib import Path

#: the repository checkout root — the single source for in-repo default
#: paths (profile cache, model registry); env vars override per path
REPO_ROOT = Path(__file__).resolve().parents[3]
