"""Decode attention's device time a decode step: the kernels, copies and
memsets launched inside the port's ``attn.decode`` spans (the cache write,
scores, softmax and weighted sum of ``models/attention.decode_attention_local``,
every layer) over the traced ``model.decode_step`` spans, in ms."""
from portbench.lib.spans import per_step_ms


def read(rec):
    return per_step_ms(rec, ("attn.decode",), "model.decode_step")
