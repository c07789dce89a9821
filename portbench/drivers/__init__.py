"""One driver per kind of traffic (``serve``, ``train``), named by a
workload's ``driver`` key.  ``run(Run) -> dict`` drives the port through
set-up, the measured window and, with ``--trace 1``, a traced stretch,
then decides ``correct`` against the reference."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class Run:
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    out_dir: Path
    # calibration only: also read the control (and, for training, the
    # planted faults) against the reference
    controls: bool = False
    # host-clock times of set-up's phases, by name
    marks: dict = dataclasses.field(default_factory=dict)

    def mark(self, name: str) -> None:
        self.marks[name] = time.perf_counter()


@contextlib.contextmanager
def collector_pauses():
    """The cyclic garbage collector's pauses in the body, as a list of
    (generation, seconds) filled as they happen."""
    pauses: list = []
    started: list = []

    def note(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((info["generation"], time.perf_counter() - started.pop()))

    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)
