"""The Mamba mixers in the traced decode steps: their least bytes (each
mixer's weights once, its SSM and conv states read and written once, its
input and output rows) over 3.35 TB/s, over the device time under the
port's ``mamba.mixer`` spans in those steps, in percent.  None unless the
record's steps are the trace's."""
from portbench.lib import cost, family
from portbench.lib.named_spans import decode_span_s


def read(rec):
    got = decode_span_s(rec, "mamba.mixer")
    steps = [u for u in rec.get("span_units", []) if u["kind"] == "decode"]
    if got is None or len(steps) != got[1]:
        return None
    fam, dm = family.load(rec["family"]), rec["dims"]
    nbytes = sum(fam.mamba_bytes(dm, u["rows"]) for u in steps)
    return 100.0 * nbytes / cost.HBM_BW / got[0]
