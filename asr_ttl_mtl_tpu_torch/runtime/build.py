"""Hash-cached C++ build of the native runtime library.

Counterpart of `asr_ttl_mtl_tpu/runtime/build.py:15-51`: the same compiler
flags, the library named by the hash of its source, built into a temporary
file and renamed into place, so that threads or processes that build at
once each see either no library or a whole one. The port builds its own
copy of the source (`native/`) into `asr_ttl_mtl_tpu_torch/_build/`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-fno-math-errno")


def compiler():
    """The host's C++ compiler (g++, else c++), or None."""
    return shutil.which("g++") or shutil.which("c++")


def build_library(source_name: str = "audio_decoder.cpp") -> str:
    """Compile native/<source_name> into a shared library, or reuse the one
    built from the same source. Returns the .so path; raises ImportError
    when no compiler is present or the build fails."""
    src = os.path.join(NATIVE_DIR, source_name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(source_name)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    gxx = compiler()
    if gxx is None:
        raise ImportError("no C++ compiler available for the native runtime")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *FLAGS, src, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise ImportError(f"native runtime build failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path
