"""The share of the traced decode steps that replayed the port's CUDA
graphs: 100 x its ``decode.graph`` spans (one inside each
``model.decode_step`` that replays, ``models/decode_graph.py``) over its
``model.decode_step`` spans in the host-ops trace, in %.  0 where the
model takes the eager step (a hybrid or MoE model, the sharded decode).
None where the run was not traced or traced no decode step, and where the
port has no graph path (no ``repro_torch.models.decode_graph`` module):
such a port opens no such span whatever it runs."""
import importlib.util

from portbench.lib.named_spans import of_record

STEP, GRAPH = "model.decode_step", "decode.graph"


def _has_graph_path() -> bool:
    try:
        return importlib.util.find_spec("repro_torch.models.decode_graph") is not None
    except ModuleNotFoundError:
        return False


def read(rec):
    if not _has_graph_path():
        return None
    a = of_record(rec, (STEP, GRAPH))
    if a is None or not a["count"].get(STEP):
        return None
    return 100.0 * a["count"].get(GRAPH, 0) / a["count"][STEP]
