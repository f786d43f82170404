"""The window path at head widths 32 and 128: the port's `DecodingTask.run`
against the JAX package's on the same carried weights and log-mel, greedy
with float KV and with int8 KV, and beam 3, at dh 32 (d 128, 4 heads) and
dh 128 (d 256, 2 heads), the rest as SMALL. The JAX side runs its decode
kernels (K1, K2, K9) in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu.decoding import DecodingOptions as JOptions
from asr_ttl_mtl_tpu.decoding import DecodingTask as JTask
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu_torch import decoding as PDec

from torch_port_helpers import model_pair, waveforms

LP_TOL = 1e-4  # avg_logprob and no_speech_prob: fp32 both sides
# head width -> the small model's widths
GEOMETRY = {dh: dict(n_audio_state=4 * dh if dh == 32 else 2 * dh, n_audio_head=4 if dh == 32 else 2,
                     n_text_state=4 * dh if dh == 32 else 2 * dh, n_text_head=4 if dh == 32 else 2)
            for dh in (32, 128)}


@pytest.fixture(scope="module", params=[32, 128], ids=["dh32", "dh128"])
def window(request):
    jmodel, tmodel = model_pair(seed=1, **GEOMETRY[request.param])
    audio = waveforms(2, 2 * 96, seed=7)
    return jmodel, tmodel, np.asarray(JA.log_mel_spectrogram(audio, use_pallas=False))


BENCH = dict(language="en", without_timestamps=True, sample_len=12, suppress_tokens="-1,50257", fp16=False)


@pytest.mark.parametrize("opts", [dict(BENCH, kv_quant=False), dict(BENCH, kv_quant=True),
                                  dict(language="en", sample_len=8, fp16=False, beam_size=3)],
                         ids=["greedy-float-kv", "greedy-kv_quant", "beam3"])
def test_decoding_task_matches_jax(window, opts):
    """Identical tokens and text; avg_logprob and no_speech_prob within 1e-4."""
    jmodel, tmodel, mel = window
    JW.set_decode_kernel("interpret")
    try:
        jres = JTask(jmodel, JOptions(**opts)).run(jnp.asarray(mel))
    finally:
        JW.set_decode_kernel("auto")
    tres = PDec.DecodingTask(tmodel, PDec.DecodingOptions(**opts)).run(torch.from_numpy(mel.copy()))
    assert len(jres) == len(tres) == 2
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens and t.text == j.text
        assert abs(t.avg_logprob - j.avg_logprob) <= LP_TOL
        assert abs(t.no_speech_prob - j.no_speech_prob) <= LP_TOL
