"""Beam search: the port's `DecodingTask` with `beam_size` against the JAX
`DecodingTask` (its K9 in interpret mode) on the same weights and log-mel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu import beam as JB
from asr_ttl_mtl_tpu.decoding import DecodingOptions as JOptions
from asr_ttl_mtl_tpu.decoding import DecodingTask as JTask
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu_torch import beam as PB
from asr_ttl_mtl_tpu_torch import decoding as PD
from asr_ttl_mtl_tpu_torch import from_random

from torch_port_helpers import cuda_device, model_pair, waveforms  # noqa: F401

LP_TOL = 1e-4  # sum_logprobs / avg_logprob: fp32 both sides
EOT = 50257


def _boost_eot(jmodel, tmodel, alpha: float):
    """Give both models the same final-LayerNorm bias b and add alpha*b/|b|^2
    to EOT's (tied) embedding row, so that EOT's logit sits near alpha and
    beams end at different steps: random weights alone almost never emit
    EOT, and the finished set would never fill."""
    rng = np.random.RandomState(0)
    bias = rng.randn(128).astype(np.float32)
    bias *= 10 / np.linalg.norm(bias)
    emb = np.array(jmodel.params["decoder"]["token_embedding"])
    emb[EOT] += alpha * bias / np.dot(bias, bias)
    jmodel.params["decoder"]["token_embedding"] = jnp.asarray(emb)
    jmodel.params["decoder"]["ln"]["bias"] = jnp.asarray(bias)
    with torch.no_grad():
        tmodel.decoder.token_embedding.weight.copy_(torch.from_numpy(emb))
        tmodel.decoder.ln.bias.copy_(torch.from_numpy(bias))


@pytest.fixture(scope="module")
def setup():
    pairs = {}
    for alpha in (0.75, 1.0):
        jmodel, tmodel = model_pair(seed=1)
        _boost_eot(jmodel, tmodel, alpha)
        pairs[alpha] = (jmodel, tmodel)
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(3, 2 * 96, seed=7), use_pallas=False))
    return pairs, mel


def _port_run(tmodel, opts, mel):
    task = PD.DecodingTask(tmodel, PD.DecodingOptions(**opts))
    return task, task.run(torch.from_numpy(mel.copy()))


@pytest.mark.parametrize(
    "alpha,opts",
    [
        # float caches (K2 with group 5): finished sets of 5 filled on some
        # audios, topped up from the live beams on others
        (0.75, dict(beam_size=5, kv_quant=False)),
        # int8 caches (K1), patience 2 (10 slots), the length penalty
        (0.75, dict(beam_size=3, patience=2.0, length_penalty=0.6, kv_quant=True)),
        # every audio's set fills before the horizon: the JAX loop stops
        # there, the port at its next exit check (8 steps)
        (1.0, dict(beam_size=5, sample_len=24)),
    ],
    ids=["beam5-float-kv", "beam3-patience2-lp0.6-kv_quant", "beam5-early-finish"],
)
def test_beam_matches_jax(setup, alpha, opts):
    """Identical tokens and text; avg_logprob and no_speech_prob within 1e-4.
    Timestamps on, 3 audios in one batch."""
    pairs, mel = setup
    jmodel, tmodel = pairs[alpha]
    opts = dict(dict(language="en", sample_len=16, fp16=False), **opts)
    JW.set_decode_kernel("interpret")
    try:
        jres = JTask(jmodel, JOptions(**opts)).run(jnp.asarray(mel))
    finally:
        JW.set_decode_kernel("auto")
    task, tres = _port_run(tmodel, opts, mel)
    assert len(jres) == len(tres) == 3
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens and t.text == j.text
        assert abs(t.avg_logprob - j.avg_logprob) <= LP_TOL
        assert abs(t.no_speech_prob - j.no_speech_prob) <= LP_TOL
        assert t.compression_ratio == pytest.approx(j.compression_ratio)
    # the case is what its id says: some, or all, beams retired into the set
    arrays, _ = PB.dispatch_beam(task, *task._encode_audio(torch.from_numpy(mel.copy()), True)[1:],
                                 np.tile(np.asarray(task.initial_tokens), (3, 1)))
    fin_count, steps = arrays[2].tolist(), arrays[-1]
    slots = round(opts["beam_size"] * opts.get("patience", 1.0))
    if alpha == 1.0:
        assert fin_count == [slots] * 3 and steps < opts["sample_len"]
    else:
        assert any(n < slots for n in fin_count) and steps == opts["sample_len"]


def test_language_detection_with_beam(setup):
    """Language unknown: detection writes the token, and the prefill reads
    the cross K/V of the split (non-fused) path, as in JAX."""
    pairs, mel = setup
    jmodel, tmodel = pairs[0.75]
    opts = dict(beam_size=3, sample_len=10, fp16=False, without_timestamps=True)
    JW.set_decode_kernel("interpret")
    try:
        jres = JTask(jmodel, JOptions(**opts)).run(jnp.asarray(mel))
    finally:
        JW.set_decode_kernel("auto")
    _, tres = _port_run(tmodel, opts, mel)
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens and t.language == j.language
        assert abs(t.avg_logprob - j.avg_logprob) <= LP_TOL


def test_submit_collect_equals_run(setup):
    pairs, mel = setup
    _, tmodel = pairs[0.75]
    task = PD.DecodingTask(tmodel, PD.DecodingOptions(language="en", beam_size=4, sample_len=8, fp16=False))
    mel_t = torch.from_numpy(mel.copy())
    first, second = task.submit(mel_t), task.submit(mel_t)
    assert first[0].func is PB.collect_beam
    a, b = task.collect(first), task.collect(second)
    want = task.run(mel_t)
    assert [r.tokens for r in a] == [r.tokens for r in b] == [r.tokens for r in want]
    assert [r.avg_logprob for r in a] == [r.avg_logprob for r in want]


def test_assemble_matches_jax():
    """The host assembly (EOT slicing, top-up from the live beams) on the
    same seeded outputs."""
    rng = np.random.RandomState(3)
    n_audio, K, C, valid_len, L = 3, 4, 6, 5, 20
    fin_tokens = rng.randint(0, 60000, size=(n_audio, C, L))
    fin_tokens[:, :, valid_len + 4] = EOT
    fin_scores = -rng.rand(n_audio, C).astype(np.float32) * 10
    fin_count = np.array([6, 2, 0])
    live = rng.randint(0, 50000, size=(n_audio * K, L))
    live_lp = (-rng.rand(n_audio * K) * 10).astype(np.float32)
    live_lp[[1, 6]] = -1e9  # dead beams are never used
    outs = (fin_tokens, fin_scores, fin_count, live, live_lp, rng.rand(n_audio), np.int32(9))
    assert PB.assemble_beam_results(outs, n_audio, K, valid_len, EOT)[:2] == JB.assemble_beam_results(
        outs, n_audio, K, valid_len, EOT
    )[:2]


def test_fp16_false_still_decodes_on_cpu(setup):
    pairs, mel = setup
    _, tmodel = pairs[0.75]
    _, res = _port_run(tmodel, dict(language="en", beam_size=2, sample_len=6, fp16=False), mel)
    assert all(np.isfinite(r.avg_logprob) for r in res)


# ------------------------------------------------------------ the card ----


@pytest.mark.cuda
def test_fp16_false_is_refused_on_card(cuda_device):  # noqa: F811
    """The card's kernels serve bf16, fp16 and fp32: fp16=False (fp32) is
    taken, and so is an fp16 model with fp16=True (fp16 serving), which
    refuses nothing now."""
    model = from_random("tiny", seed=0, device=cuda_device, dtype=torch.bfloat16)
    assert PD.DecodingTask(model, PD.DecodingOptions(language="en", fp16=False)).compute_dtype == torch.float32
    half = from_random("tiny", seed=0, device=cuda_device, dtype=torch.float16)
    assert PD.DecodingTask(half, PD.DecodingOptions(language="en", fp16=True)).compute_dtype == torch.float16


@pytest.mark.cuda
def test_beam_on_card_runs_k9(cuda_device):  # noqa: F811
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    model = from_random("tiny", seed=0, device=cuda_device, dtype=torch.bfloat16)
    mel = torch.randn(2, 80, 3000, device=cuda_device) * 0.3
    opts = PD.DecodingOptions(language="en", beam_size=5, sample_len=16, suppress_tokens=f"-1,{EOT}")
    reset_launch_counts()
    res = PD.DecodingTask(model, opts).run(mel)
    assert LAUNCHES["topk_logprobs"] == 16
    assert all(len(r.tokens) == 16 and np.isfinite(r.avg_logprob) for r in res)
    # 9 beams share a cross row: K2 serves the whole group in one launch
    wide = PD.DecodingTask(model, PD.DecodingOptions(language="en", beam_size=9, sample_len=16,
                                                     suppress_tokens=f"-1,{EOT}")).run(mel)
    assert all(len(r.tokens) == 16 and np.isfinite(r.avg_logprob) for r in wide)
