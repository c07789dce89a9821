"""The flash-attention backward (``kernels/csrc/flash_attention_bwd.cu``: its
dot, dK/dV, partial-sum and dQ kernels together) in the traced training
steps: the larger of the 5 causal products it needs over 495 TFLOP/s and its
bytes over 3.35 TB/s, over its device time, in percent."""
from portbench.lib import cost
from portbench.lib.readers import kernel_roofline

KERNELS = ("flash_bwd_dot_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_sum_kernel",
           "flash_bwd_dq_kernel")


def read(rec):
    dm, wl = rec["dims"], rec["workload"]
    rows = wl["batch"] // wl["microbatches"]
    calls = [(rows, wl["seq_len"], wl["seq_len"], dm.heads, dm.kv_heads, dm.head_dim)] * (
        rec["trace_steps"] * wl["microbatches"] * dm.layers)
    return kernel_roofline(rec, KERNELS, "flash_bwd_dkdv_kernel", calls, cost.flash_bwd)
