"""The MoE FFNs' device time a decode step: the kernels, copies and memsets
launched inside the port's ``moe.ffn`` spans (the router, the top-K, the
experts' products and the combine of ``models/moe.moe_apply``, every MoE
layer) within the traced ``model.decode_step`` spans, over those steps, in
ms."""
from portbench.lib.named_spans import per_step_ms


def read(rec):
    return per_step_ms(rec, "moe.ffn")
