"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX package is the oracle: a test builds JAX parameters, carries them
into the port with `state_dict_from_jax_params`, feeds both sides the same
numpy inputs and compares. Sizes stay small: 2 layers, d=128 with 2 heads
(dh=64, so `h2_eligible` holds), n_audio_ctx 96 (the encoder pads its keys
to 128 and masks the tail), fp32.
"""

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
