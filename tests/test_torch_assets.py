"""The port's asset search order (`asr_ttl_mtl_tpu_torch/utils/assets.py`)
against the JAX package's (`asr_ttl_mtl_tpu/utils/assets.py`), and the
tokenizer reading its rank table from `$ASRMTL_ASSET_DIR` first."""

import os
import shutil

import pytest

from asr_ttl_mtl_tpu.utils import assets as JAssets
from asr_ttl_mtl_tpu_torch import tokenizer as PT
from asr_ttl_mtl_tpu_torch.utils import assets as PAssets


@pytest.fixture
def fresh_ranks():
    PT.load_ranks.cache_clear()
    yield
    PT.load_ranks.cache_clear()


def test_asset_dir_comes_first(tmp_path, monkeypatch, fresh_ranks):
    """A cut copy of gpt2.tiktoken in $ASRMTL_ASSET_DIR is the table the
    tokenizer reads, as the JAX package's search finds it first."""
    shipped = os.path.join(PAssets.PACKAGE_ASSET_DIR, "gpt2.tiktoken")
    with open(shipped) as f:
        head = [next(f) for _ in range(300)]
    (tmp_path / "gpt2.tiktoken").write_text("".join(head))
    monkeypatch.setenv("ASRMTL_ASSET_DIR", str(tmp_path))
    found = PAssets.find_asset("gpt2.tiktoken")
    assert found == str(tmp_path / "gpt2.tiktoken")
    assert found == JAssets.find_asset("gpt2.tiktoken", os.path.join(os.path.dirname(JAssets.__file__), "..",
                                                                      "assets"), "whisper/assets/gpt2.tiktoken")
    assert len(PT.load_ranks("gpt2")) == 300


def test_search_order_and_refusal(tmp_path, monkeypatch):
    """Without $ASRMTL_ASSET_DIR the JAX package's assets/ serves; then the
    XDG cache, then $ASRMTL_REFERENCE_DIR/whisper/assets/; a missing file
    raises FileNotFoundError naming every directory searched."""
    monkeypatch.delenv("ASRMTL_ASSET_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("ASRMTL_REFERENCE_DIR", str(tmp_path / "ref"))
    assert PAssets.find_asset("multilingual.tiktoken") == os.path.join(PAssets.PACKAGE_ASSET_DIR,
                                                                        "multilingual.tiktoken")
    dirs = PAssets.search_dirs()
    assert dirs == [PAssets.PACKAGE_ASSET_DIR, str(tmp_path / "xdg" / "asr_ttl_mtl_tpu"),
                    str(tmp_path / "ref" / "whisper" / "assets")]
    assert PAssets.cache_dir() == JAssets.cache_dir()
    os.makedirs(dirs[2])
    shutil.copy(os.path.join(PAssets.PACKAGE_ASSET_DIR, "gpt2.tiktoken"), os.path.join(dirs[2], "table.bin"))
    assert PAssets.find_asset("table.bin") == os.path.join(dirs[2], "table.bin")
    os.makedirs(dirs[1])
    shutil.copy(os.path.join(dirs[2], "table.bin"), os.path.join(dirs[1], "table.bin"))
    assert PAssets.find_asset("table.bin") == os.path.join(dirs[1], "table.bin")
    with pytest.raises(FileNotFoundError) as err:
        PAssets.find_asset("absent.tiktoken")
    for directory in dirs:
        assert directory in str(err.value)
