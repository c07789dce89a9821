"""The decode step's weight-streaming product (``kernels/csrc/decode_proj.cu``)
in the traced stretch: the least time of the products it runs there (each
decode step's q/k/v, output projection, dense MLP and head weights read
once, each launch's rows in and out, at 3.35 TB/s, or their FLOPs at 495
TFLOP/s where larger; a prefill's head at its last position;
``lib/decode_proj.py``), over the device time of its launches, in percent.
The work comes from the sizes, not from the launch count.  None where the
trace holds no launch of the kernel (a port without it)."""
from portbench.lib import cost, decode_proj
from portbench.lib.trace import kernel_name

KERNEL = "decode_proj_kernel"


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    device_s = sum(d for n, _, d in t["ops"] if kernel_name(n) == KERNEL)
    if not device_s:
        return None
    least = sum(cost.roofline_s(*decode_proj.cost_of(rec["dims"], u["rows"],
                                                     prefill=u["kind"] == "prefill"))
                for u in rec["trace_units"])
    return 100.0 * least / device_s
