"""The window's training FLOPs (forward and backward, no recomputation) over
the window's length at 495 TFLOP/s, in percent."""
from portbench.lib.readers import mfu as read  # noqa: F401
