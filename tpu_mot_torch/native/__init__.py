"""ctypes bindings for the native host runtime (a copy of
tpu_mot/native: the same C++ sources and entry points).

The compute path runs on the card; the host runtime around it is C++: an
exact Hungarian assignment solver, a MOT det-file parser, BGR->gray
conversion, an SPSC frame ring buffer for decode->device staging and the
multi-stream batch scheduler.  The library is built by g++ at first use
(`ensure_built`) into tpu_mot_torch/_build/, named by a hash of the
sources and flags, so an edit rebuilds and an unchanged checkout reuses its
build.  Every entry point has a pure-Python fallback with the same
semantics, so the package works without a toolchain.

  from tpu_mot_torch import native
  native.ensure_built()            # compiles the library if missing
  row_to_col = native.assign(cost, feasible)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
_lib = None


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cc"))


def lib_path() -> Path:
    """Where the library of these exact sources and flags lives."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpumot_host_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile src/*.cc with g++ unless a build of these sources exists.
    Returns (library path, seconds spent compiling (0.0 when reused));
    raises when g++ is missing or fails."""
    lib = lib_path()
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                        *map(str, _sources())], capture_output=True,
                       text=True, check=True)
        os.replace(tmp, lib)      # atomic: concurrent builders both succeed
    finally:
        tmp.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0


def ensure_built(quiet: bool = True) -> bool:
    """Build the library if needed and load it; returns availability.  A
    host without g++ (or where the build fails) gets False, and every
    entry point takes its Python fallback; quiet=False reports why."""
    if _lib is None:
        try:
            build()
        except (OSError, subprocess.CalledProcessError) as exc:
            if not quiet:
                print(f"native: build failed: {exc}; "
                      f"{getattr(exc, 'stderr', '')}")
    return _load()


def _load() -> bool:
    global _lib
    if _lib is not None:
        return True
    path = lib_path()
    if not path.is_file():
        return False
    lib = ctypes.CDLL(str(path))
    lib.tpumot_assign.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int32)]
    lib.tpumot_parse_mot_csv.restype = ctypes.c_int64
    lib.tpumot_parse_mot_csv.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.tpumot_bgr_to_gray.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.tpumot_ring_create.restype = ctypes.c_void_p
    lib.tpumot_ring_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
    lib.tpumot_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.tpumot_ring_push.restype = ctypes.c_int32
    lib.tpumot_ring_push.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.tpumot_ring_pop.restype = ctypes.c_int64
    lib.tpumot_ring_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.tpumot_ring_size.restype = ctypes.c_int32
    lib.tpumot_ring_size.argtypes = [ctypes.c_void_p]
    lib.tpumot_sched_create.restype = ctypes.c_void_p
    lib.tpumot_sched_create.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int64]
    lib.tpumot_sched_destroy.argtypes = [ctypes.c_void_p]
    lib.tpumot_sched_push.restype = ctypes.c_int32
    lib.tpumot_sched_push.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64]
    lib.tpumot_sched_gather.restype = ctypes.c_int32
    lib.tpumot_sched_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.tpumot_sched_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return True


def available() -> bool:
    return _lib is not None or _load()


_BIG = 1e9


def assign(cost: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """Exact min-cost assignment (native Hungarian); same interface as
    ops.assignment.scipy_assign. Falls back to SciPy when unbuilt."""
    if not available():
        from tpu_mot_torch.ops.assignment import scipy_assign
        return scipy_assign(cost, feasible)
    n, m = cost.shape
    c = np.where(feasible, cost, _BIG).astype(np.float64, order="C")
    out = np.empty((n,), np.int32)
    _lib.tpumot_assign(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, m, _BIG,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def parse_mot_csv(path: str) -> np.ndarray:
    """det/gt CSV → [rows, 7] float64 (frame, id, x, y, w, h, score).
    Falls back to numpy.loadtxt when unbuilt."""
    if not available():
        raw = np.loadtxt(path, delimiter=",", ndmin=2)
        out = np.ones((len(raw), 7))
        out[:, : min(7, raw.shape[1])] = raw[:, :7]
        return out
    n = _lib.tpumot_parse_mot_csv(path.encode(), None, 0)
    if n < 0:
        raise IOError(f"cannot parse {path}")
    out = np.empty((n, 7), np.float64)
    got = _lib.tpumot_parse_mot_csv(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n)
    return out[:got]


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 BGR → [H, W] uint8 gray (BT.601 fixed point)."""
    if not available():
        b = bgr.astype(np.uint32)
        return ((77 * b[..., 2] + 150 * b[..., 1] + 29 * b[..., 0]) >> 8
                ).astype(np.uint8)
    h, w, _ = bgr.shape
    src = np.ascontiguousarray(bgr)
    out = np.empty((h, w), np.uint8)
    _lib.tpumot_bgr_to_gray(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h * w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


class FrameRing:
    """SPSC frame ring buffer over the native implementation."""

    def __init__(self, capacity: int, frame_bytes: int):
        if not available():
            raise RuntimeError("the native library is not built; call "
                               "ensure_built()")
        self._ptr = _lib.tpumot_ring_create(capacity, frame_bytes)
        self.frame_bytes = frame_bytes

    def push(self, frame: np.ndarray) -> bool:
        buf = np.ascontiguousarray(frame, dtype=np.uint8)
        return bool(_lib.tpumot_ring_push(
            self._ptr, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.nbytes))

    def pop(self, shape, dtype=np.uint8):
        out = np.empty(shape, dtype)
        got = _lib.tpumot_ring_pop(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.nbytes)
        if got == 0:
            return None
        if got < 0:
            # The native side returns a flat -1 for a frame larger than
            # the caller's buffer (ingest.cc), not a byte count.
            raise ValueError(
                f"stored ring frame is larger than the pop buffer "
                f"({out.nbytes} bytes) — mismatched frame geometry")
        if got != out.nbytes:
            # A smaller stored frame would leave the np.empty tail
            # uninitialized — same geometry mismatch, other direction.
            raise ValueError(
                f"stored ring frame is {got} bytes but the pop buffer "
                f"expects {out.nbytes} — mismatched frame geometry")
        return out

    def __len__(self):
        return int(_lib.tpumot_ring_size(self._ptr))

    def __del__(self):
        # Module globals may already be torn down at interpreter exit.
        if getattr(self, "_ptr", None) and _lib is not None:
            _lib.tpumot_ring_destroy(self._ptr)
            self._ptr = None


class StreamScheduler:
    """Multi-stream batch assembly: N decode threads push into per-stream
    SPSC rings; a single gather() builds the [n_streams, ...] device batch
    with a repeat-last-frame policy for late streams (real-time serving
    never blocks on a slow decoder).  Native-backed when the library is
    built; pure-Python deque fallback otherwise.

    >>> sched = StreamScheduler(8, frame_shape=(1080, 1920), capacity=4)
    >>> sched.push(stream_id, frame)            # from decode threads
    >>> batch, fresh = sched.gather()           # from the device feeder
    >>> sched.stats()                           # drops / repeats / fresh
    """

    def __init__(self, n_streams: int, frame_shape, capacity: int = 4,
                 dtype=np.uint8):
        self.n_streams = n_streams
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(self.frame_shape)
                               * self.dtype.itemsize)
        self._native = ensure_built()
        if self._native:
            self._ptr = _lib.tpumot_sched_create(n_streams, capacity,
                                                 self.frame_bytes)
        else:
            import collections
            import threading
            self._rings = [collections.deque(maxlen=capacity)
                           for _ in range(n_streams)]
            self._locks = [threading.Lock() for _ in range(n_streams)]
            self._last = [None] * n_streams
            self._dropped = np.zeros(n_streams, np.int64)
            self._repeated = np.zeros(n_streams, np.int64)
            self._fresh = np.zeros(n_streams, np.int64)
            self._capacity = capacity

    def push(self, stream: int, frame) -> bool:
        buf = np.ascontiguousarray(frame, dtype=self.dtype)
        if buf.nbytes != self.frame_bytes:
            raise ValueError(f"frame is {buf.nbytes} bytes, expected "
                             f"{self.frame_bytes}")
        if not (0 <= stream < self.n_streams):
            # Match the native backend's bounds behavior (scheduler.cc
            # returns 0) instead of raising IndexError only on the
            # Python fallback.
            return False
        if self._native:
            return bool(_lib.tpumot_sched_push(
                self._ptr, stream,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                buf.nbytes))
        with self._locks[stream]:
            if len(self._rings[stream]) >= self._capacity:
                self._dropped[stream] += 1
                return False
            self._rings[stream].append(buf.copy())
            return True

    def gather(self):
        """Returns (batch [n_streams, *frame_shape], fresh [n_streams]
        bool) or None while some stream has never produced a frame."""
        if self._native:
            out = np.empty((self.n_streams,) + self.frame_shape, self.dtype)
            fresh = np.zeros((self.n_streams,), np.uint8)
            n = _lib.tpumot_sched_gather(
                self._ptr,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                fresh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if n < 0:
                return None
            return out, fresh.astype(bool)
        # Readiness precheck so an incomplete batch consumes nothing
        # (rings only grow from the producer side).
        for i in range(self.n_streams):
            if self._last[i] is None and not self._rings[i]:
                return None
        out = np.empty((self.n_streams,) + self.frame_shape, self.dtype)
        fresh = np.zeros((self.n_streams,), bool)
        for i in range(self.n_streams):
            with self._locks[i]:
                if self._rings[i]:
                    self._last[i] = self._rings[i].popleft()
                    self._fresh[i] += 1
                    fresh[i] = True
                else:
                    self._repeated[i] += 1
            out[i] = self._last[i].reshape(self.frame_shape)
        return out, fresh

    def stats(self) -> dict:
        if self._native:
            dropped = np.zeros(self.n_streams, np.int64)
            repeated = np.zeros(self.n_streams, np.int64)
            fresh = np.zeros(self.n_streams, np.int64)
            p = ctypes.POINTER(ctypes.c_int64)
            _lib.tpumot_sched_stats(self._ptr,
                                    dropped.ctypes.data_as(p),
                                    repeated.ctypes.data_as(p),
                                    fresh.ctypes.data_as(p))
        else:
            dropped, repeated, fresh = (self._dropped, self._repeated,
                                        self._fresh)
        return {"dropped": dropped.tolist(), "repeated": repeated.tolist(),
                "fresh": fresh.tolist()}

    def __del__(self):
        if (getattr(self, "_native", False) and getattr(self, "_ptr", None)
                and _lib is not None):
            _lib.tpumot_sched_destroy(self._ptr)
            self._ptr = None
