"""The flash-attention forward kernel (``kernels/csrc/flash_attention.cu``)
in the traced prefills: the larger of its needed causal products over 495
TFLOP/s and its bytes over 3.35 TB/s, over its device time, in percent."""
from portbench.lib import cost
from portbench.lib.readers import kernel_roofline


def read(rec):
    dm = rec["dims"]
    calls = [(u["rows"], u["length"], u["length"], dm.heads, dm.kv_heads, dm.head_dim)
             for u in rec["trace_units"] if u["kind"] == "prefill"] * dm.attn_layers
    return kernel_roofline(rec, ("flash_fwd_kernel",), "flash_fwd_kernel", calls,
                           cost.flash_fwd)
