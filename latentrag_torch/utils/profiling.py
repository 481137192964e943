"""Device profiling: ``torch.profiler`` traces and device-synchronised
wall-clock spans; the JAX package's ``utils/profiling.py`` on PyTorch.

* ``trace(dir)``: a context manager around ``torch.profiler.profile``
  over the CPU and, where a card is visible, CUDA activities; on exit it
  writes one ``*.pt.trace.json`` into ``dir`` (TensorBoard's profiler
  plugin and ``chrome://tracing`` load it). The card's kernels appear in
  it by name, those the port launches through ctypes included.
* ``annotate(name)``: a named span on the trace's timeline
  (``torch.profiler.record_function``).
* ``timed_blocked(store, key, *outputs)``: a wall-clock span that waits
  for the device work behind ``outputs`` before it stops the clock (CUDA
  kernels return before the card finishes).
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

import torch

from .timing import force_completion

log = logging.getLogger("latentrag_torch.utils")


@contextmanager
def trace(log_dir: str):
    """Profile the block; write its trace into ``log_dir``."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    log.info("profiler trace written to %s", log_dir)


def annotate(name: str):
    """Named span that shows up on the trace's timeline."""
    return torch.profiler.record_function(name)


@contextmanager
def timed_blocked(store: dict, key: str, *outputs):
    """Add the block's wall seconds to ``store[key]``, after the device
    work that produced ``outputs`` (tensors; the block may append more to
    the yielded list) has finished."""
    t0 = time.perf_counter()
    collected = list(outputs)
    try:
        yield collected
    finally:
        for out in collected:
            force_completion(out)
        store[key] = store.get(key, 0.0) + (time.perf_counter() - t0)
