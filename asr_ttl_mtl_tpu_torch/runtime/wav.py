"""ctypes bindings to the native audio runtime (`native/audio_decoder.cpp`).

Counterpart of `asr_ttl_mtl_tpu/runtime/wav.py:24-146`, with the same
functions and error codes:
  * read(file)                       -> (float32 mono, sample rate)
  * resample(x, orig_sr, target_sr)  -> float32, scipy resample_poly's
    Kaiser polyphase filter
  * load_batch(paths, sr, length)    -> ((n, length) float32, per-file status)

The library is built and loaded at the first call, not at import: `lib()`
raises ImportError where it cannot be built, and the callers then take the
Python reader. `CALLS` counts the `load_batch` calls, so that a run can
show that the native route ran.
"""

from __future__ import annotations

import ctypes
import os
import threading
from math import gcd
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .build import build_library

ERRORS = {
    -1: "cannot open file",
    -2: "file too small",
    -3: "short read",
    -4: "not a RIFF/WAVE file",
    -5: "missing fmt/data chunk",
    -6: "zero sample width",
    -7: "unsupported WAV format",
    -100: "out of memory",
}

CALLS: Dict[str, int] = {"load_batch": 0}

_LIB = None
_LOCK = threading.Lock()
_F32P = ctypes.POINTER(ctypes.c_float)


def _open() -> ctypes.CDLL:
    """Load the built library; a stale artifact that does not load is
    removed and built once more, then ImportError."""
    path = build_library("audio_decoder.cpp")
    try:
        return ctypes.CDLL(path)
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
        path = build_library("audio_decoder.cpp")
        try:
            return ctypes.CDLL(path)
        except OSError as e:
            raise ImportError(f"native audio runtime unusable: {e}") from e


def lib() -> ctypes.CDLL:
    """The native library, built at the first call (ImportError when it cannot be)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = _open()
            handle.wav_read.restype = ctypes.c_long
            handle.wav_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int)]
            handle.audio_free.restype = None
            handle.audio_free.argtypes = [_F32P]
            handle.resample_f32.restype = ctypes.c_long
            handle.resample_f32.argtypes = [_F32P, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_F32P)]
            handle.load_batch.restype = ctypes.c_int
            handle.load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_long,
                                          _F32P, ctypes.POINTER(ctypes.c_long), ctypes.c_int]
            _LIB = handle
        return _LIB


def read(file: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to mono float32 at its own sample rate."""
    native = lib()
    data_p = _F32P()
    sr = ctypes.c_int(0)
    n = native.wav_read(os.fsencode(file), ctypes.byref(data_p), ctypes.byref(sr))
    if n < 0:
        raise RuntimeError(f"{file}: {ERRORS.get(n, f'error {n}')}")
    try:
        out = np.ctypeslib.as_array(data_p, shape=(n,)).copy() if n else np.zeros((0,), np.float32)
    finally:
        native.audio_free(data_p)
    return out, sr.value


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Kaiser polyphase resampling, as `audio.resample` (scipy) computes it."""
    if orig_sr == target_sr:
        return np.asarray(audio, np.float32)
    native = lib()
    x = np.ascontiguousarray(audio, np.float32)
    g = gcd(orig_sr, target_sr)
    out_p = _F32P()
    n = native.resample_f32(x.ctypes.data_as(_F32P), x.shape[0], target_sr // g, orig_sr // g, ctypes.byref(out_p))
    if n < 0:
        raise RuntimeError(ERRORS.get(n, f"resample error {n}"))
    try:
        return np.ctypeslib.as_array(out_p, shape=(n,)).copy() if n else np.zeros((0,), np.float32)
    finally:
        native.audio_free(out_p)


def load_batch(paths: Sequence[str], target_sr: int, target_len: int, n_threads: int = 0
               ) -> Tuple[np.ndarray, List[int]]:
    """Decode, resample and pad or trim a batch of WAV files on the
    library's thread pool. Returns ((n, target_len) float32, status):
    status[i] is file i's decoded length at target_sr, or a negative error
    code, and then its row is zeros."""
    native = lib()
    n = len(paths)
    out = np.zeros((n, target_len), np.float32)
    status = np.zeros((n,), np.int64)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    native.load_batch(c_paths, n, target_sr, target_len, out.ctypes.data_as(_F32P),
                      status.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_threads)
    CALLS["load_batch"] += 1
    return out, status.tolist()
