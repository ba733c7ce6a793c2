"""The file decoder: a ctypes wrapper over the repository's FFmpeg decoder
(port of ``tstar_tpu/video/decoder.py``, without its OpenCV fallback).

``native/video_decoder.cpp`` opens a container once and serves:

  * ``probe``            -- fps, frame count and size, from the header;
  * ``decode_sweep``     -- one forward pass that keeps a frame per sampling
                            period (the frame cache's decode);
  * ``decode_batch``     -- random-access reads with keyframe seeks (the
                            streaming cache, keyframes, QA and evaluation
                            frames).

The library is read in place, ``native/libtstar_video.so``.  When it is
missing or does not load, ``native/video_decoder.cpp`` is compiled with
``g++`` and the ``pkg-config`` flags of ``native/Makefile`` into
``tstar_tpu_torch/_build/``; ``native/`` is never written.  When that fails
too, opening a video raises ``RuntimeError`` with both errors: there is no
other decoder to give way to.  A file that cannot be opened raises
``ValueError``.

A handle is not thread-safe: open one per thread.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO / "native"
LIB_PATH = NATIVE_DIR / "libtstar_video.so"
SOURCE = NATIVE_DIR / "video_decoder.cpp"
BUILD_DIR = _REPO / "tstar_tpu_torch" / "_build"
_PKG_CONFIG = ["libavformat", "libavcodec", "libavutil", "libswscale"]

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class VideoMeta:
    fps: float
    total_frames: int
    width: int
    height: int

    @property
    def duration(self) -> float:
        return self.total_frames / self.fps if self.fps else 0.0


def _build_library() -> Path:
    """Compile ``native/video_decoder.cpp`` into ``_build/`` (as
    ``native/Makefile`` does) -> the library's path.  Concurrent builds each
    write a file of their own and rename it into place."""
    flags = subprocess.run(
        ["pkg-config", "--cflags", "--libs", *_PKG_CONFIG],
        capture_output=True, text=True, timeout=60,
    )
    if flags.returncode != 0:
        raise RuntimeError(f"pkg-config {' '.join(_PKG_CONFIG)}: {flags.stderr.strip()}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "libtstar_video.so"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", str(tmp),
           str(SOURCE), *flags.stdout.split()]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}:\n{done.stderr.strip()}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.vd_probe.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vd_error.restype = ctypes.c_char_p
    lib.vd_error.argtypes = [ctypes.c_void_p]
    lib.vd_decode_batch.restype = ctypes.c_int
    lib.vd_decode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.vd_decode_sweep.restype = ctypes.c_int
    lib.vd_decode_sweep.argtypes = [
        ctypes.c_void_p,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
    ]
    return lib


def load_library() -> ctypes.CDLL:
    """The decoder library: ``LIB_PATH`` in place, else built from
    ``SOURCE``.  Raises ``RuntimeError`` with both errors when neither
    works (and again on every later call, without retrying)."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise RuntimeError(_lib_error)
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError as load_error:
            built = BUILD_DIR / "libtstar_video.so"
            try:
                lib = ctypes.CDLL(str(built if built.exists() else _build_library()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as build_error:
                _lib_error = (
                    f"the video decoder library is unavailable: loading {LIB_PATH} failed "
                    f"({load_error}); building it from {SOURCE} failed ({build_error})"
                )
                raise RuntimeError(_lib_error) from build_error
        _lib = _bind(lib)
        return _lib


class NativeDecoder:
    """A decoder handle over one video file."""

    def __init__(self, path: str):
        lib = load_library()
        self._lib = lib
        self._h = lib.vd_open(os.fsencode(path))
        if not self._h:
            raise ValueError(f"Cannot open video file: {path}")
        self.path = path
        fps = ctypes.c_double()
        frames = ctypes.c_int64()
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.vd_probe(self._h, fps, frames, w, h)
        self.meta = VideoMeta(fps.value, int(frames.value), w.value, h.value)

    def decode_batch(self, indices: Sequence[int], out_hw: Optional[tuple] = None) -> np.ndarray:
        """Frames at ``indices`` -> (n, h, w, 3) uint8 RGB, resized to
        ``out_hw`` (h, w) when given."""
        h, w = out_hw if out_hw else (self.meta.height, self.meta.width)
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        out = np.empty((len(idx), h, w, 3), np.uint8)
        n = self._lib.vd_decode_batch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        )
        if n != len(idx):
            err = self._lib.vd_error(self._h).decode()
            raise RuntimeError(f"decode_batch wrote {n}/{len(idx)} frames for {self.path}: {err}")
        return out

    def decode_sweep(self, period: float, count: int, out_hw: Optional[tuple] = None) -> np.ndarray:
        """``count`` frames, the first at or after each multiple of
        ``period`` seconds; a stream that ends early repeats its last
        frame."""
        h, w = out_hw if out_hw else (self.meta.height, self.meta.width)
        out = np.empty((count, h, w, 3), np.uint8)
        n = self._lib.vd_decode_sweep(
            self._h, period, count, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        )
        if n <= 0:
            err = self._lib.vd_error(self._h).decode()
            raise RuntimeError(f"decode_sweep failed for {self.path}: {err}")
        if n < count:
            out[n:] = out[n - 1]
        return out

    def close(self) -> None:
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter shutdown
            pass


def open_video(path: str) -> NativeDecoder:
    """A decoder handle over ``path`` (``ValueError`` when the file cannot be
    opened, ``RuntimeError`` when the decoder library is unavailable)."""
    return NativeDecoder(os.fspath(path))


@contextlib.contextmanager
def opened(video_path: str, decoder=None):
    """``decoder`` itself when given (its owner closes it), else
    ``video_path`` opened for the block and closed after it."""
    if decoder is not None:
        yield decoder
        return
    dec = open_video(video_path)
    try:
        yield dec
    finally:
        dec.close()
