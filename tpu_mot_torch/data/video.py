"""Video ingest: host decode feeding device-resident frame batches (a copy
of tpu_mot/data/video.py; OpenCV imported inside read_video only).

Decode runs on the host (optionally through the C++ ring buffer in
tpu_mot_torch.native) and frames are staged to the device in
double-buffered chunks, so decode of chunk k+1 overlaps device tracking of
chunk k.
"""

from __future__ import annotations

import threading
import queue as queue_mod

import numpy as np


def read_video(path: str, gray: bool = True, limit: int | None = None):
    """Decode a whole video file into a [N, H, W] (gray) uint8 stack."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        if gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        frames.append(img)
        if limit and len(frames) >= limit:
            break
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0), np.uint8)


class ChunkedVideoPipeline:
    """Double-buffered host→device ingest.

    Decodes frames (from a video path, image dir, or any frame iterator)
    into fixed-size chunks on a background thread while the device tracks
    the previous chunk.  Usage:

    >>> pipe = ChunkedVideoPipeline(frame_iter, chunk=32)
    >>> for chunk in pipe:            # np.uint8 [<=chunk, H, W]
    ...     bank, out = scan.run_sequence(bank, torch.as_tensor(chunk,
    ...                                       device="cuda"), ...)
    """

    def __init__(self, frames_iter, chunk: int = 32, prefetch: int = 2):
        self.chunk = chunk
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self.thread = threading.Thread(
            target=self._worker, args=(iter(frames_iter),), daemon=True)
        self.thread.start()

    def _worker(self, it):
        buf = []
        try:
            for frame in it:
                buf.append(np.asarray(frame))
                if len(buf) == self.chunk:
                    self.q.put(np.stack(buf))
                    buf = []
            if buf:
                self.q.put(np.stack(buf))
            self.q.put(None)
        except BaseException as exc:  # noqa: BLE001 — re-raised in __iter__
            # A mid-stream decode failure must not masquerade as clean EOF:
            # hand the exception to the consumer instead of the sentinel.
            self.q.put(exc)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
