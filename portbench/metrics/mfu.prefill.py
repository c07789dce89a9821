"""The window's model FLOPs (the blocks' products, causal attention, the head
at each prompt's last position, and the batches' decode steps) over the
window's length at 495 TFLOP/s, in percent."""
from portbench.lib.readers import mfu as read  # noqa: F401
