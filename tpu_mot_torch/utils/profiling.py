"""Tracing / profiling utilities (counterpart of
tpu_mot/utils/profiling.py):

  * `span(name)` marks a stage of the serving path as a `record_function`
    range while a torch.profiler capture is on, and costs one check
    otherwise.  The ranges sit in the capture beside the card's kernels
    (CUPTI), on the profiler's clock.
  * `trace()` wraps a block in a torch.profiler trace (the card's kernels
    through CUPTI when there is a card, and the spans) and writes it as a
    Chrome trace (Perfetto / chrome://tracing readable).
  * `DeviceTimer` gives wall timing that waits for the observed tensors'
    device.
  * `FpsMeter` is the serving loop's frame-rate counter.

The spans, `<layer>.<stage>`, each inside the one above it on the calling
thread (one serving call is one request):

  parallel/serve.py      serve.step      multi_stream_step
                         serve.detect    the detector call of a fused
                                         detect -> track step (with the
                                         shared batch's all-gather)
  models/detector.py     detector.detect      detect_batch
                         detector.preprocess  frames -> the net's input
                         detector.forward     the net
                         detector.decode      heads -> boxes in frame pixels
                         detector.nms         class-wise NMS, padded output
  models/yolo.py         detector.backbone    in detector.forward: the trunk
                                              up to the heads' routes
                                              (darknet-53 for yolov3)
                         detector.head0..2    in detector.forward, one a
                                              head: its upsample conv and
                                              route concat, conv set,
                                              pre-head conv, linear head
  tracker/step.py        tracker.step         step_streams (bank and output
                                              assembly in its self time)
                         tracker.frames       gray image or u8 pyramid
                         tracker.predict      1. Kalman predict
                         tracker.kcf_detect   2. KCF detect, PSR, refined boxes
                         tracker.cost         3. cost matrix
                         tracker.assign       4. auction, det_taken
                         tracker.correct      5. Kalman correct
                         tracker.lifecycle    6/7. lifecycle, births
                         tracker.kcf_train    8. KCF training
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

TRACE_NAME = "trace.json"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` range while a torch.profiler capture is
    on, else a shared null context: `with span("tracker.predict"): ...`."""
    if torch._C._autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _OFF


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
