"""Native host runtime (C++): WAV decode, resampling and batch loading.

Counterpart of `asr_ttl_mtl_tpu/runtime/`. The port keeps its own copy of
the source (`native/audio_decoder.cpp`), builds it with the host's C++
compiler at first use into the git-ignored `_build/` (`build.py`) and binds
it with ctypes (`wav.py`). This is host decoding: the card and its kernels
play no part in it. Where no compiler is present, `wav.lib()` raises
ImportError and the callers (`audio.py`, `mtl/dataset.py`) take the Python
reader, the JAX package's own contract.

Modules:
  * build  - hash-cached g++ / c++ build of native/*.cpp
  * wav    - read / resample / load_batch over ctypes
"""
