"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX package is the oracle: a test builds JAX parameters, carries them
into the port with `state_dict_from_jax_params`, feeds both sides the same
numpy inputs and compares. Sizes stay small: 2 layers, d=128 with 2 heads
(dh=64, so `h2_eligible` holds), n_audio_ctx 96 (the encoder pads its keys
to 128 and masks the tail), fp32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.models.dims import ModelDimensions
from asr_ttl_mtl_tpu.models.registry import WhisperModel as JaxWhisperModel

from asr_ttl_mtl_tpu_torch.models import ModelDimensions as TorchDims
from asr_ttl_mtl_tpu_torch.models import WhisperModel, state_dict_from_jax_params

SMALL = dict(
    n_mels=80, n_audio_ctx=96, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
    n_vocab=51865, n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2,
)


def jax_dims(**kw) -> ModelDimensions:
    return ModelDimensions(**{**SMALL, **kw})


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def model_pair(seed: int = 0, **kw):
    """(JAX WhisperModel, port WhisperModel) with the same fp32 weights."""
    dims = jax_dims(**kw)
    params = JW.init_params(jax.random.PRNGKey(seed), dims)
    jmodel = JaxWhisperModel(dims=dims, params=params, compute_dtype=jnp.float32)
    tmodel = WhisperModel(TorchDims(**{**SMALL, **kw}), compute_dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax_params(np_tree(params), dims))
    return jmodel, tmodel.eval().requires_grad_(False)


def waveforms(batch: int, n_frames: int, seed: int) -> np.ndarray:
    """Seeded tones plus noise giving `n_frames` log-mel frames."""
    rng = np.random.RandomState(seed)
    t = np.arange(n_frames * 160, dtype=np.float32) / 16000
    f = rng.uniform(100, 4000, size=(batch, 1)).astype(np.float32)
    wave = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.randn(batch, t.size)
    return wave.astype(np.float32)


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the training slice's test set-up: 2+2 layers, d=128 with 2 heads, 64
# audio positions from 20480 samples, fp32, batch 4 (the vocab is expanded
# to 51869 by the multilingual disease tokenizer), on one device:
# tests/conftest.py gives JAX 8 virtual CPU devices, and mesh_shape (1, 1)
# keeps the JAX trainer on its single-device path, the one the port follows
DEBUG_DIMS = dict(
    n_mels=80, n_audio_ctx=64, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
    n_vocab=51865, n_text_ctx=96, n_text_state=128, n_text_head=2, n_text_layer=2,
)
TRAIN_CONFIG = dict(
    model_size="tiny", pretrained="random", debug_dims=DEBUG_DIMS, audio_samples=20480,
    compute_dtype="float32", batch_size=4, val_batch_size=4, learning_rate=1e-3,
    token_buckets=(48, 96), num_workers=2, seed=0, chunked_ce=True, epochs=1, mesh_shape=(1, 1),
)
WORDS = "the patient said hello there how are you fine thanks speech voice test one two".split()


def write_wav_dataset(directory, n: int, seed: int, missing=()):
    """Seeded 16 kHz int16 WAVs of 0.2-1.2 s with seeded transcripts and
    classes 0-2, and a CSV (file,text,class) naming them; rows in `missing`
    name a file that does not exist. Returns the CSV path."""
    import wave

    rng = np.random.RandomState(seed)
    rows = ["file,text,class"]
    for i in range(n):
        path = os.path.join(str(directory), f"clip{seed}_{i}.wav")
        if i not in missing:
            t = np.arange(int(16000 * rng.uniform(0.2, 1.2))) / 16000
            pcm = 3000 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t) + 500 * rng.randn(t.size)
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(pcm.astype(np.int16).tobytes())
        text = " ".join(rng.choice(WORDS, size=rng.randint(2, 8)))
        rows.append(f"{path},{text},{i % 3}")
    csv_path = os.path.join(str(directory), f"data{seed}.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_path
