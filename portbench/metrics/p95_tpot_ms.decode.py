"""The 95th percentile of the gaps between a request's consecutive tokens
in the window, in ms, from the CUDA events the serving stream records
after each step (no sync added, so a host stall counts)."""
from portbench.lib.readers import p95_tpot_ms as read  # noqa: F401
