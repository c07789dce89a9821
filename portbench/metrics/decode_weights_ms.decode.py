"""The decode step's device time outside attention, a decode step: what the
port launches inside its ``model.decode_step`` span and in no ``attn.decode``
span within it (the q/k/v, output, MLP and head products, rope, RMSNorm and
the residual adds, every layer), over the traced ``model.decode_step``
spans, in ms."""
from portbench.lib.spans import per_step_ms


def read(rec):
    return per_step_ms(rec, ("model.decode_step",), "model.decode_step")
