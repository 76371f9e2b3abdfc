"""Tracing / profiling utilities (counterpart of
tpu_mot/utils/profiling.py):

  * `trace()` wraps a block in a torch.profiler trace (the card's kernels
    through CUPTI when there is a card) and writes it as a Chrome trace
    (Perfetto / chrome://tracing readable).
  * `DeviceTimer` gives wall timing that waits for the observed tensors'
    device.
  * `summarize_trace()` aggregates a written trace's device kernels by
    name, host-side, for quick terminal triage.
  * `FpsMeter` is the serving loop's frame-rate counter.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a block, written to
    log_dir/trace.json: `with trace("traces/run1") as prof: ...`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class DeviceTimer:
    """Wall timer that waits for the observed tensors' device.

    >>> with DeviceTimer() as t:
    ...     out = step(...)
    ...     t.observe(out)
    >>> t.elapsed
    """

    def __enter__(self):
        self._out = None
        self.t0 = time.perf_counter()
        return self

    def observe(self, out):
        self._out = out

    def __exit__(self, *exc):
        devices = {t.device for t in _tensors(self._out) if t.is_cuda}
        for dev in devices:
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self.t0
        return False


# Chrome-trace categories of work on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(log_dir: str, top: int = 15):
    """Aggregate the device events of the newest trace in log_dir (as
    `trace` writes it) by name: [(name, total_ms, count)], busiest first.
    A trace without a card has no device events: []."""
    paths = sorted(glob.glob(os.path.join(log_dir, "*.json")),
                   key=os.path.getmtime)
    if not paths:
        return []
    with open(paths[-1]) as f:
        tr = json.load(f)
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = e.get("name", "?")
        agg[name] += e.get("dur", 0)
        cnt[name] += 1
    return [(name, dur / 1e3, cnt[name])
            for name, dur in agg.most_common(top)]


class FpsMeter:
    """Structured frame-rate/latency counter for serving loops."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: collections.deque = collections.deque(maxlen=window)
        self.n_frames = 0

    def tick(self, n: int = 1):
        self.times.append((time.perf_counter(), n))
        self.n_frames += n

    @property
    def fps(self) -> float:
        if len(self.times) < 2:
            return 0.0
        (t0, _), (t1, _) = self.times[0], self.times[-1]
        frames = sum(n for _, n in list(self.times)[1:])
        return frames / max(t1 - t0, 1e-9)

    def stats(self) -> dict:
        return {"fps": round(self.fps, 1), "frames": self.n_frames}
