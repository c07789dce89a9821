"""The flash-decode kernel (``kernels/csrc/decode_attention.cu``: its
attention kernel and, where it splits, the merge) in the traced decode
steps: each call's least bytes (the filled k/v positions once, the new
token's k/v written, q read and o written) over 3.35 TB/s, or its 2
products over 495 TFLOP/s where larger, over its device time, in percent."""
from portbench.lib import cost
from portbench.lib.readers import kernel_roofline

KERNELS = ("decode_attn_kernel", "decode_merge_kernel")


def read(rec):
    dm = rec["dims"]
    calls = [(u["rows"], u["position"], dm.heads, dm.kv_heads, dm.head_dim)
             for u in rec["trace_units"] if u["kind"] == "decode"] * dm.attn_layers
    return kernel_roofline(rec, KERNELS, "decode_attn_kernel", calls, cost.flash_decode)
