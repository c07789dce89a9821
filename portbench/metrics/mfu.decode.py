"""The decode steps' share of HBM's 3.35 TB/s, in percent: each step's least
bytes (every weight once, the filled k/v positions once) over its measured
time, summed over the window's steps."""
from portbench.lib.readers import decode_bandwidth as read  # noqa: F401
