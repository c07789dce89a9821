"""The MoE FFNs in the traced decode steps: their least bytes (in each MoE
layer, the distinct experts the step routed to, counted from the port's
routing record, read once, the router read, the rows in and out) over
3.35 TB/s, over the device time under the port's ``moe.ffn`` spans in
those steps, in percent.  None unless the record's steps are the trace's."""
from portbench.lib import cost, family
from portbench.lib.named_spans import decode_span_s


def read(rec):
    got = decode_span_s(rec, "moe.ffn")
    steps = [u for u in rec.get("span_units", []) if u["kind"] == "decode"]
    if got is None or len(steps) != got[1] or not all(u.get("experts") for u in steps):
        return None
    fam, dm = family.load(rec["family"]), rec["dims"]
    nbytes = sum(fam.moe_bytes(dm, u["rows"], u["experts"]) for u in steps)
    return 100.0 * nbytes / cost.HBM_BW / got[0]
