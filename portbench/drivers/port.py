"""The system under test: the port's ``Model`` built from the ``ArchConfig``
that the configuration's family gives for its sizes, and a check that the
benchmark's weights have the layout its ``abstract_params()`` lists."""
from __future__ import annotations


def model(fam, dm, cfg: dict, device):
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.transformer import RunConfig

    return Model(fam.arch(dm, cfg), RunConfig(), device=device)


def check_layout(m, params: dict) -> None:
    """Raise unless ``params`` has the tree, shapes and dtypes of
    ``m.abstract_params()``."""
    from repro_torch import tree as tree_lib

    want, _ = m.abstract_params()
    try:
        tree_lib.map(lambda w, p: None, want, params)  # indexes params by want's keys
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"the weights' tree is not the port's: {e!r}") from e
    ws, ps = tree_lib.leaves(want), tree_lib.leaves(params)
    if len(ws) != len(ps):
        raise ValueError(f"the weights have {len(ps)} leaves, the port {len(ws)}")
    for w, p in zip(ws, ps):
        if w.shape != p.shape or w.dtype != p.dtype:
            raise ValueError(f"weight {tuple(p.shape)} {p.dtype} where the port has "
                             f"{tuple(w.shape)} {w.dtype}")
