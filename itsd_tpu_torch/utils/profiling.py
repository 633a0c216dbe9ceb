"""Profiling: Chrome traces of the host and the card from torch.profiler.

Counterpart of ``itsd_tpu/utils/profiling.py``, rebuilt on
``torch.profiler`` (JAX's writes ``jax.profiler`` traces): ``trace``
captures a block when ``log_dir`` or ``$ITSD_TRACE_DIR`` is set, ``annotate``
names a region in the trace, and ``trace_steps`` captures the first n steps
of a loop, which the train loop runs for ``train.profile_steps``. A trace
is written as ``trace.json`` in its directory (open it in Perfetto or
chrome://tracing). The CUDA activity is recorded when a card is present.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


def _start() -> profile:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: profile, log_dir: str) -> str:
    """Wait for the card's queued work, so that it lands in the trace,
    stop ``prof`` and write its Chrome trace under ``log_dir``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Trace the block into ``log_dir`` (or ``$ITSD_TRACE_DIR``); a no-op
    when neither is set."""
    log_dir = log_dir or os.environ.get("ITSD_TRACE_DIR")
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    prof = _start()
    try:
        yield
    finally:
        _stop(prof, log_dir)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the profiler's timeline."""
    with record_function(name):
        yield


class trace_steps:
    """Trace the first ``n_steps`` iterations of a loop into ``log_dir``::

        profiler = trace_steps(cfg.train.profile_steps, trace_dir)
        for batch in data:
            with profiler.step():
                metrics = step_fn(state, batch, generator)
        profiler.close()

    The trace starts at the first step, each step is a region
    ``step_{i}``, and after the last one the card's work is waited for and
    ``log_dir/trace.json`` written (``path``). ``close`` writes it when the
    loop ended first. ``n_steps=0`` makes every call a no-op."""

    def __init__(self, n_steps: int, log_dir: str):
        self.n_steps = n_steps
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self._seen = 0
        self._prof: Optional[profile] = None

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        if self.n_steps <= 0 or self._seen >= self.n_steps:
            yield
            return
        if self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = _start()
        try:
            with record_function(f"step_{self._seen}"):
                yield
        finally:
            self._seen += 1
            if self._seen >= self.n_steps:
                self.close()

    def close(self) -> None:
        if self._prof is not None:
            self.path = _stop(self._prof, self.log_dir)
            self._prof = None
