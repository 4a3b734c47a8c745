"""Tracing and profiling.

Port of ``tactilesimulation_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` capture of CPU activity, and of
  CUDA activity where a card is in use, written into ``logdir`` as a Chrome
  trace (``tensorboard_trace_handler``: ``*.pt.trace.json``), which
  TensorBoard's profiler plugin and Perfetto read;
- ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``);
- ``PhaseTimer``: named wall-clock phases that wait for the device at
  their end, so its work counts to the phase that launched it;
- ``device_memory_stats(device)``: the CUDA caching allocator's counters.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

from .tree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into ``logdir``: CPU activity, and CUDA activity
    where a card is present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """A named trace region: ``with annotate("rollout"): ...``."""
    return torch.profiler.record_function(name)


def _sync(tree):
    devices = {t.device for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    >>> pt = PhaseTimer()
    >>> with pt.phase("rollout") as box:
    ...     out = rollout_fn(...)
    ...     box["sync"] = out
    >>> pt.report()   # {'rollout': {'total_s': ..., 'calls': ..., 'mean_s': ...}}

    ``sync`` (a tree of tensors, given to ``phase`` or put in the box) is
    waited on at the phase's end: ``torch.cuda.synchronize`` on each CUDA
    device its tensors lie on.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            tree = box.get("sync", sync)
            if tree is not None:
                _sync(tree)
            self.totals[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "calls": self.calls[k],
                    "mean_s": self.totals[k] / max(self.calls[k], 1)}
                for k in self.totals}

    def log_to(self, writer, step: int, prefix: str = "profile/"):
        """Write each phase's mean seconds to a SummaryWriter-like object."""
        for name, total in self.totals.items():
            writer.add_scalar(f"{prefix}{name}_mean_s",
                              total / max(self.calls[name], 1), step)

    def reset(self):
        self.totals.clear()
        self.calls.clear()


def device_memory_stats(device=None) -> Dict:
    """The CUDA caching allocator's statistics of ``device``
    (``torch.cuda.memory_stats``) with ``free_bytes`` and ``total_bytes``
    (``torch.cuda.mem_get_info``); {} for a CPU device. ``device`` None is
    the current CUDA device where a card is present, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["free_bytes"], stats["total_bytes"] = torch.cuda.mem_get_info(
        device)
    return stats
