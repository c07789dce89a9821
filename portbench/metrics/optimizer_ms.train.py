"""AdamW's device time a training step: what the port launches inside its
``optim.apply_updates`` span (global norm, clipping, every leaf's update)
over the traced steps' ``optim.apply_updates`` spans, in ms."""
from portbench.lib.spans import per_step_ms


def read(rec):
    return per_step_ms(rec, ("optim.apply_updates",), "optim.apply_updates")
