"""The Mamba mixers' device time a decode step: what the port launches
inside its ``mamba.mixer`` spans (in_proj, the conv and scan step, the
dt/B/C norms, x_proj, dt_proj, out_proj of ``models/mamba.mamba_apply``,
every mixer) within the traced ``model.decode_step`` spans, over those
steps, in ms."""
from portbench.lib.named_spans import per_step_ms


def read(rec):
    return per_step_ms(rec, "mamba.mixer")
