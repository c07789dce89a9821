"""Ranges on the torch profiler's clock at the port's layer boundaries.

``span(name)`` opens a profiler range named ``name`` while a torch profiler
runs, so the range lands in the profiler's trace on the same clock as the
kernels it launches: each kernel's ``correlation`` id leads to its launch
on the host, and the launch lies inside the range.  With no profiler
running it returns :data:`_NULL_SPAN`, one shared no-op context manager:
one flag read, no clock read, no allocation, no range.  The spans are on
exactly while the process is profiled; nothing else switches them.

The range is torch's ``_RecordFunctionFast`` (a ``cpu_op`` event in the
trace), not ``record_function``: it records only through the callbacks the
profiler installs when it records host activity, so under a profiler of
device activity alone it records nothing and costs under a microsecond,
where an idle ``record_function`` costs ~10 us of host time and would
slow the very stretch whose idle time that profiler measures.

The model (``model.prefill``, ``model.decode_step``, ``attn.decode``,
``moe.ffn`` around each MoE FFN, ``mamba.mixer`` around each Mamba mixer)
and the optimizer (``optim.apply_updates``) open these spans.
"""
from __future__ import annotations

import torch._C._profiler as _c_profiler
import torch.autograd.profiler as _profiler


class _NullSpan:
    """The shared no-op span: zero clock reads, zero allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(name: str):
    """A profiler range named ``name`` while a torch profiler runs, else
    :data:`_NULL_SPAN`."""
    if _profiler._is_profiler_enabled:
        return _c_profiler._RecordFunctionFast(name)
    return _NULL_SPAN
