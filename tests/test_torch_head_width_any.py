"""Every head width that is a multiple of 8 up to 128: `ops.width_class`
and K2's shared-memory plan at each; the plain K7 with lse, K8 (through
`jax.vjp` of `flash_attention_vjp`), K2, K1 and K5 against the JAX
functions in interpret mode at dh 24, 40 and 80; and the slice at d 160, 2
heads of 80: `DecodingTask.run` greedy with float and int8 KV and beam 3,
and one train step, against the JAX package on the same carried weights;
and at d 384, 2 heads of 192 (K5's route B on the card), greedy with float
KV. The kernels at these widths on the card are in
test_torch_head_width_card.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu.decoding import DecodingOptions as JOptions
from asr_ttl_mtl_tpu.decoding import DecodingTask as JTask
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.mtl import MultiTaskSpeechDataset as JDataset
from asr_ttl_mtl_tpu.mtl import MultiTaskTrainer as JTrainer
from asr_ttl_mtl_tpu.mtl import TrainingConfig as JConfig
from asr_ttl_mtl_tpu.mtl import collate as jcollate
from asr_ttl_mtl_tpu.mtl.dataset import audio_buckets
from asr_ttl_mtl_tpu.ops import decode_attention as JD
from asr_ttl_mtl_tpu.ops import flash_attention as JF
from asr_ttl_mtl_tpu_torch import decoding as PDec
from asr_ttl_mtl_tpu_torch import ops
from asr_ttl_mtl_tpu_torch.models import state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of
from asr_ttl_mtl_tpu_torch.mtl.trainer import classifier_state_from_jax
from asr_ttl_mtl_tpu_torch.ops import decode_attention as PD
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF

from torch_port_helpers import DEBUG_DIMS, TRAIN_CONFIG, model_pair, np_tree, waveforms, write_wav_dataset

ATOL = 1e-5  # fp32 both sides; only the order of the sums differs (as test_torch_head_width.py)
LP_TOL = 1e-4  # avg_logprob and no_speech_prob (as test_torch_head_width_decode.py)
REL = 1e-4  # the loss and gradient norms (as test_torch_head_width_train.py)
WIDTHS = [24, 40, 80]  # classes 32, 64 and 128, each below its class
# the slice: 2 heads of 80 (class 128), 2 + 2 layers, fp32
D80 = dict(n_audio_state=160, n_audio_head=2, n_text_state=160, n_text_head=2)
# 2 heads of 192 (d 384: no h2 shape, K5 above 128), 2 + 2 layers, fp32
D192 = dict(n_audio_state=384, n_audio_head=2, n_text_state=384, n_text_head=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=0)


# ------------------------------------------------ the width classes ------


@pytest.mark.parametrize("dh", range(8, 129, 8))
def test_width_class_and_k2_plan_at_every_multiple_of_8(dh):
    """width_class gives the smallest of 32, 64 and 128 at or above dh, and
    K2's plan at that class fits a CTA's shared memory for the paths'
    groups (1, the beam's 5, 16) over one window, 32 windows and a 448-row
    self cache, with bf16 and fp32 caches."""
    cls = ops.width_class(dh)
    assert cls == min(c for c in ops.WIDTH_CLASSES if c >= dh)
    assert cls // 2 < dh <= cls or cls == 32
    n_head = max(1, 1280 // dh // 8)
    for itemsize in (2, 4):
        for batch, n_keys, group in ((1, 1500, 1), (1, 1500, 5), (32, 1500, 1), (8, 1500, 5), (1, 448, 16)):
            split = PD.k2_plan(batch, n_head, n_keys, group, itemsize, cls)
            assert PD.k2_smem_bytes(group, -(-n_keys // split), itemsize, cls) <= 227 * 1024


@pytest.mark.parametrize("dh", [0, 4, 20, 132, 136, 256])
def test_width_class_refuses_the_rest(dh):
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 128"):
        ops.width_class(dh)


# ------------------------------------------------- K7-lse and K8 ------


@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("causal,q_offset,kv_valid_len", [(True, 7, 60), (False, 0, 50)], ids=["causal", "cross"])
def test_k7_lse_and_k8_plain_match_jax(dh, causal, q_offset, kv_valid_len):
    """K7 with lse and its gradient (K8 through jax.vjp of the JAX package's
    flash_attention_vjp) at a width below its class."""
    bh, tq, tk = 2, 40, 64
    q, k, v, g = _inputs([(bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh)], seed=dh + tq)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention(q, k, v, return_lse=True, interpret=True, **kw)
        jout2, vjp = jax.vjp(lambda a, b, c: JF.flash_attention_vjp(a, b, c, causal, q_offset, kv_valid_len,
                                                                    dh**-0.5), q, k, v)
        jgrads = vjp(jnp.asarray(g))
    pout, plse = PF.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    _close(pout, jout)
    _close(plse, jlse)
    _close(pout, jout2)
    for a, c in zip(PF.flash_attention_bwd(_t(q), _t(k), _t(v), pout, plse, _t(g), **kw), jgrads):
        _close(a, c)


# ----------------------------------------------------- K2, K1, K5 ------


@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("group,valid", [(1, None), (5, 37)])
def test_k2_and_k1_plain_match_jax(dh, group, valid):
    """K2 over fp32 caches and K1 over int8 caches (tk_blk 128) at 3 heads
    of dh; K1 within the plain version's flip bound plus fp32 noise."""
    n_head, b, tk = 3, 2, 128
    d = n_head * dh
    rng = np.random.RandomState(dh + group)
    q = (rng.randn(b * group, 1, d) * 0.5).astype(np.float32)
    ck, cv = (rng.randn(2, b, tk, d).astype(np.float32) for _ in range(2))
    kw = dict(scale=dh**-0.5, valid_upto=valid, group=group)
    want = JD.decode_attention(q, ck, cv, 1, n_head, interpret=True, **kw)
    _close(PD.decode_attention(_t(q), _t(ck), _t(cv), 1, n_head, **kw), want)
    ki, ks = JD.quantize_kv_rows(jnp.asarray(ck))
    vi, vs = JD.quantize_kv_rows(jnp.asarray(cv))
    want = JD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, interpret=True, **kw)
    got, flip = PD.decode_attention_i8_plain(_t(q), _t(ki), _t(ks), _t(vi), _t(vs), 1, n_head,
                                             return_flip_bound=True, **kw)
    diff = np.abs(got.numpy() - np.asarray(want))
    assert np.all(diff <= ATOL + flip.numpy()), (diff - flip.numpy()).max()


@pytest.mark.parametrize("dh", WIDTHS)
def test_k5_plain_matches_pallas(dh):
    """K5 (the fp32 kernel's plain version) over the natural layout at 3
    heads of dh, keys valid to 50 of 64."""
    n_head, b, tq, tk = 3, 2, 32, 64
    d = n_head * dh
    assert PF.mh_flash_eligible(tq, tk, d, n_head, False) == JF.mh_flash_eligible(tq, tk, d, n_head, False) is True
    q, k, v = _inputs([(b, tq, d), (b, tk, d), (b, tk, d)], seed=dh)
    kw = dict(n_head=n_head, kv_valid_len=50, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention_mh(q, k, v, interpret=True, **kw)
    _close(PF.flash_attention_mh(_t(q), _t(k), _t(v), **kw), want)


# ------------------------------------------- the slice at 2 heads of 80 ------


@pytest.fixture(scope="module")
def window80():
    jmodel, tmodel = model_pair(seed=3, **D80)
    audio = waveforms(2, 2 * 96, seed=8)
    return jmodel, tmodel, np.asarray(JA.log_mel_spectrogram(audio, use_pallas=False))


BENCH = dict(language="en", without_timestamps=True, sample_len=12, suppress_tokens="-1,50257", fp16=False)


@pytest.mark.parametrize("opts", [dict(BENCH, kv_quant=False), dict(BENCH, kv_quant=True),
                                  dict(language="en", sample_len=8, fp16=False, beam_size=3)],
                         ids=["greedy-float-kv", "greedy-kv_quant", "beam3"])
def test_decoding_task_matches_jax_at_dh80(window80, opts):
    """Identical tokens and text; avg_logprob and no_speech_prob within 1e-4."""
    jmodel, tmodel, mel = window80
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


def test_decoding_task_matches_jax_at_dh192(monkeypatch):
    """2 heads of 192, greedy with float KV: the encoder runs K5 (its plain
    version here) at a width above 128, and gives the JAX package's tokens
    and text, avg_logprob and no_speech_prob within 1e-4."""
    jmodel, tmodel = model_pair(seed=4, **D192)
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(2, 2 * 96, seed=9), use_pallas=False))
    k5 = []
    real = PF.flash_attention_mh
    monkeypatch.setattr(PF, "flash_attention_mh", lambda *a, **kw: (k5.append(kw["n_head"]), real(*a, **kw))[1])
    opts = dict(BENCH, kv_quant=False)
    JW.set_decode_kernel("interpret")
    try:
        jres = JTask(jmodel, JOptions(**opts)).run(jnp.asarray(mel))
    finally:
        JW.set_decode_kernel("auto")
    tres = PDec.DecodingTask(tmodel, PDec.DecodingOptions(**opts)).run(torch.from_numpy(mel.copy()))
    assert len(jres) == len(tres) == 2 and k5 and set(k5) == {2}
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens and t.text == j.text
        assert abs(t.avg_logprob - j.avg_logprob) <= LP_TOL
        assert abs(t.no_speech_prob - j.no_speech_prob) <= LP_TOL


def test_train_step_matches_jax_at_dh80(tmp_path):
    """One MultiTaskTrainer step from the same carried weights, batch and
    dropout keep-mask at 2 heads of 80: the loss and every group's gradient
    norm within 1e-4 of the JAX step's."""
    d = D80["n_audio_state"]
    cfg = dict(TRAIN_CONFIG, debug_dims=dict(DEBUG_DIMS, **D80))
    jtr = JTrainer(JConfig(**cfg, save_dir=str(tmp_path / "jax")), verbose=False)
    ptr = MultiTaskTrainer(TrainingConfig(**cfg, device="cpu", save_dir=str(tmp_path / "port")), verbose=False)
    ptr.load_state(state_dict_from_jax_params(np_tree(jtr.model.params), jtr.model.dims),
                   classifier_state_from_jax(np_tree(jtr.classifier_params)))
    ds = JDataset(write_wav_dataset(tmp_path, n=4, seed=80), JConfig(**cfg))
    batch = jcollate([ds[i] for i in range(4)], ds.tokenizer, cfg["token_buckets"], audio_buckets(ds.config))

    dev, n_valid = jtr._device_batch(batch)
    _, sub = jax.random.split(jtr._rng)
    keep = np.array(jax.random.bernoulli(sub, 0.9, (len(batch["classes"]), d // 2)))

    def loss_fn(tr):
        cls_loss, trans_loss, _ = jtr._forward(tr, dev["audio"], dev["input_tokens"], dev["target_tokens"],
                                               dev["classes"], sub, train=True, n_valid=jnp.int32(n_valid))
        a, b = jtr._effective_weights(jnp.float32(jtr.alpha), jnp.float32(jtr.beta), cls_loss, trans_loss)
        return a * cls_loss + b * trans_loss

    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(jtr._trainable())
    jnorms = {}
    for g, lab in zip(jax.tree.leaves(grads), jax.tree.leaves(jtr._optimizer_labels())):
        jnorms[lab] = jnorms.get(lab, 0.0) + float(jnp.sum(g.astype(jnp.float32) ** 2))

    ploss, _ = ptr.train_step(batch, keep=torch.from_numpy(keep))
    pnorms = {}
    for name, p in ptr.named_trainable():
        pnorms[group_of(name)] = pnorms.get(group_of(name), 0.0) + float((p.grad.double() ** 2).sum())
    assert float(ploss) == pytest.approx(float(jloss), rel=REL)
    assert set(pnorms) == set(jnorms)
    for key in jnorms:
        assert np.sqrt(pnorms[key]) == pytest.approx(np.sqrt(jnorms[key]), rel=REL), key
