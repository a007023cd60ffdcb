"""ctypes bindings for the native host-runtime library (libjanus_host).

The C++ primitives of ``janus_host.cc`` beside this file — SPSC ring
buffer, streaming deframer, token-bucket pacer — with Pythonic wrappers.
The library is built with ``g++`` at first use into
``build/janus_tpu_torch/libjanus_host.so`` at the repository root, never
into the package, and rebuilt when the source is newer. Every wrapper has
a pure-Python fallback so the package runs on toolchain-less hosts;
``HAVE_NATIVE`` reports which path is active. Host code only: nothing
here touches the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["HAVE_NATIVE", "RingBuffer", "Deframer", "Pacer", "load_library",
           "SOURCE", "LIB_PATH"]

SOURCE = Path(__file__).resolve().with_name("janus_host.cc")
LIB_PATH = (Path(__file__).resolve().parents[2] / "build" / "janus_tpu_torch"
            / "libjanus_host.so")
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _try_build() -> bool:
    """Compile into a temporary file beside the target and rename it into
    place, so that a concurrent build never loads a half-written file."""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_PATH.parent)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_CXXFLAGS, "-o", tmp, str(SOURCE)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _stale() -> bool:
    return (not LIB_PATH.exists()
            or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime)


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _stale() and not _try_build():
            return None
        lib = ctypes.CDLL(str(LIB_PATH))
        # signatures
        lib.rb_create.restype = ctypes.c_void_p
        lib.rb_create.argtypes = [ctypes.c_uint64]
        lib.rb_destroy.argtypes = [ctypes.c_void_p]
        lib.rb_size.restype = ctypes.c_uint64
        lib.rb_size.argtypes = [ctypes.c_void_p]
        lib.rb_capacity.restype = ctypes.c_uint64
        lib.rb_capacity.argtypes = [ctypes.c_void_p]
        lib.rb_push.restype = ctypes.c_uint64
        lib.rb_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.rb_pop.restype = ctypes.c_uint64
        lib.rb_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.dfr_create.restype = ctypes.c_void_p
        lib.dfr_destroy.argtypes = [ctypes.c_void_p]
        lib.dfr_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.dfr_next_len.restype = ctypes.c_int64
        lib.dfr_next_len.argtypes = [ctypes.c_void_p]
        lib.dfr_pop.restype = ctypes.c_int64
        lib.dfr_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.pacer_create.restype = ctypes.c_void_p
        lib.pacer_create.argtypes = [ctypes.c_double, ctypes.c_double]
        lib.pacer_destroy.argtypes = [ctypes.c_void_p]
        lib.pacer_acquire.restype = ctypes.c_double
        lib.pacer_acquire.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_double]
        _lib = lib
        return _lib


HAVE_NATIVE = load_library() is not None


class RingBuffer:
    """SPSC float32 ring buffer (all-or-none push/pop semantics)."""

    def __init__(self, capacity: int):
        self._lib = load_library()
        self.capacity = capacity
        if self._lib is not None:
            self._h = self._lib.rb_create(capacity)
            self._py = None
        else:
            self._h = None
            self._py = np.zeros(capacity, dtype=np.float32)
            self._head = 0
            self._tail = 0
            self._lock = threading.Lock()

    @property
    def native(self) -> bool:
        """True when this buffer is the C++ one."""
        return self._h is not None

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.rb_size(self._h))
        return self._head - self._tail

    def push(self, samples: np.ndarray) -> bool:
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        n = samples.shape[0]
        if self._h is not None:
            return bool(self._lib.rb_push(
                self._h, samples.ctypes.data_as(ctypes.c_void_p), n
            ))
        with self._lock:
            if self.capacity - (self._head - self._tail) < n:
                return False
            start = self._head % self.capacity
            first = min(n, self.capacity - start)
            self._py[start : start + first] = samples[:first]
            if n > first:
                self._py[: n - first] = samples[first:]
            self._head += n
            return True

    def pop(self, n: int) -> Optional[np.ndarray]:
        out = np.empty(n, dtype=np.float32)
        if self._h is not None:
            got = self._lib.rb_pop(self._h, out.ctypes.data_as(ctypes.c_void_p), n)
            return out if got else None
        with self._lock:
            if self._head - self._tail < n:
                return None
            start = self._tail % self.capacity
            first = min(n, self.capacity - start)
            out[:first] = self._py[start : start + first]
            if n > first:
                out[first:] = self._py[: n - first]
            self._tail += n
            return out

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.rb_destroy(self._h)
            self._h = None


class Deframer:
    """Streaming 4-byte big-endian length-prefix deframer."""

    def __init__(self):
        self._lib = load_library()
        if self._lib is not None:
            self._h = self._lib.dfr_create()
        else:
            self._h = None
            self._buf = b""

    def feed(self, data: bytes) -> None:
        if self._h is not None:
            self._lib.dfr_feed(self._h, data, len(data))
        else:
            self._buf += data

    def pop(self) -> Optional[bytes]:
        if self._h is not None:
            n = self._lib.dfr_next_len(self._h)
            if n < 0:
                return None
            out = ctypes.create_string_buffer(n)
            got = self._lib.dfr_pop(self._h, out, n)
            return out.raw[:got] if got >= 0 else None
        if len(self._buf) < 4:
            return None
        n = int.from_bytes(self._buf[:4], "big")
        if len(self._buf) < 4 + n:
            return None
        payload = self._buf[4 : 4 + n]
        self._buf = self._buf[4 + n :]
        return payload

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.dfr_destroy(self._h)
            self._h = None


class Pacer:
    """Token-bucket pacer; ``acquire(n)`` returns the sleep owed (s)."""

    def __init__(self, bytes_per_second: float, burst_bytes: float = 0.0):
        import time

        self._time = time.monotonic
        self._lib = load_library()
        if self._lib is not None:
            self._h = self._lib.pacer_create(bytes_per_second, burst_bytes)
        else:
            self._h = None
            self._bps = bytes_per_second
            self._burst = burst_bytes
            self._avail = burst_bytes
            self._last: Optional[float] = None

    def acquire(self, n_bytes: int) -> float:
        now = self._time()
        if self._h is not None:
            return float(self._lib.pacer_acquire(self._h, n_bytes, now))
        if self._last is not None:
            self._avail = min(self._burst, self._avail + (now - self._last) * self._bps)
        self._last = now
        self._avail -= n_bytes
        return 0.0 if self._avail >= 0 else -self._avail / self._bps

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.pacer_destroy(self._h)
            self._h = None
