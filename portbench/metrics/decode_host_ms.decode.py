"""Median host milliseconds of one ``Model.decode_step`` call in the window
(the host clock around each call; the call returns once its work is
enqueued)."""
from portbench.lib.readers import host_ms_median as read  # noqa: F401
