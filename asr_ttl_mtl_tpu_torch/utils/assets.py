"""Where the port finds its assets (the tiktoken rank tables), in the JAX
package's search order (`asr_ttl_mtl_tpu/utils/assets.py:20-38`), so the
two packages read the same files:

1. `$ASRMTL_ASSET_DIR`;
2. the JAX package's `assets/` directory beside this package (read only:
   the port imports nothing of that package);
3. the XDG cache, `$XDG_CACHE_HOME/asr_ttl_mtl_tpu` (`~/.cache` by default);
4. `$ASRMTL_REFERENCE_DIR/whisper/assets/`, where that variable is set.

The JAX package downloads a missing rank table into the cache as its last
resort; the port does not (it needs no network) and raises
`FileNotFoundError` naming the directories it searched.
"""

from __future__ import annotations

import os
from typing import List

PACKAGE_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "asr_ttl_mtl_tpu", "assets"
)


def cache_dir() -> str:
    default_cache = os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(os.getenv("XDG_CACHE_HOME", default_cache), "asr_ttl_mtl_tpu")


def search_dirs() -> List[str]:
    """The directories searched, in order."""
    dirs = []
    if os.environ.get("ASRMTL_ASSET_DIR"):
        dirs.append(os.environ["ASRMTL_ASSET_DIR"])
    dirs += [PACKAGE_ASSET_DIR, cache_dir()]
    if os.environ.get("ASRMTL_REFERENCE_DIR"):
        dirs.append(os.path.join(os.environ["ASRMTL_REFERENCE_DIR"], "whisper", "assets"))
    return dirs


def find_asset(filename: str) -> str:
    """The first existing `filename` in `search_dirs()`; raises
    FileNotFoundError naming the directories searched."""
    dirs = search_dirs()
    for directory in dirs:
        path = os.path.join(directory, filename)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"asset '{filename}' not found in {dirs}")
