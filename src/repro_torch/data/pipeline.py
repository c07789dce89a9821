"""Synthetic token stream with a double-buffered prefetching feeder.

``SyntheticLM.batch_at`` is the JAX package's, numpy only, so both packages
train on byte-identical batches.  ``PrefetchFeeder`` is the host-to-device
feed: a host thread makes batch i+1, stages it in pinned host memory and
copies it to the card on a side stream while step i computes (the paper's
temporal sharing of transfer and compute).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.backends.base import new_stream, release_stream
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_dim: int = 0  # >0 => also emit stub frontend embeddings


class SyntheticLM:
    """Deterministic synthetic token stream (seeded; reproducible across
    restarts: a restart at step k regenerates the identical batch k)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        tokens = rng.integers(
            0, cfg.vocab_size, (cfg.global_batch, cfg.seq_len + 1),
            dtype=np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.frontend_dim:
            out["embeds"] = rng.standard_normal(
                (cfg.global_batch, cfg.seq_len, cfg.frontend_dim)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchFeeder:
    """Stages batches onto ``device`` ``depth`` steps ahead on a host thread.

    On a card each batch is copied from pinned host memory on a side stream
    of its own (``core.backends.base.new_stream``, claimed until
    :meth:`stop`), with an event recorded after the copies; :meth:`next`
    makes the caller's current stream wait on that event and marks the
    batch's tensors as used there (``record_stream``), so the batch is read
    only after its copy and its memory is not reused while the step runs.
    On the CPU the batch is the numpy arrays as tensors."""

    def __init__(self, source: SyntheticLM, device="cuda", *, depth: int = 2,
                 start_step: int = 0):
        self.source = source
        self.device = resolve_device(device)
        self.depth = depth
        self._stream = new_stream(self.device) if self.device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, host: dict):
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
        if self._stream is None:
            return tensors, None
        with torch.cuda.stream(self._stream):
            # pinned memory handed to a non-blocking copy is kept by the
            # caching host allocator until the copy is done
            dev = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in tensors.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            item = (step, *self._stage(self.source.batch_at(step)))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        """(step, batch) of the next step, ready to read on the caller's
        current stream."""
        step, batch, done = self._q.get()
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in batch.values():
                t.record_stream(current)
        return step, batch

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        release_stream(self._stream)
        self._stream = None
