"""Every head width up to 768: K1 and K2 from 264 to 768 (`ops.decode_class`,
the classes 512 and 768) and widths off a multiple of 8 in K1, K2, K7,
K7-lse and K8 (`ops.kernel_width`). The plain K2 and K1 against the JAX
kernels in interpret mode at 264, 384, 768, 3, 20, 75 and 100; the plain
K7-lse and K8 at 3, 20, 75 and 100; the flash wrappers' route for a width
off a multiple of 8 (q, k, v laid out at the width rounded up to 8, the
kernel, the extra columns dropped) run on the CPU with the plain version in
the kernel's place; K1's and K2's shared-memory plans at every multiple of
8 from 264 to 768; `DecodingTask.run` at 2 heads of 75 (d 150) and 2 of 384
(d 768), a train step at d 150 and `state_dict_from_jax_params` at both,
each against the JAX package. The kernels at these widths on the card are
in test_torch_head_width_card.py."""

import ctypes
import functools

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
from asr_ttl_mtl_tpu.models.registry import export_torch_state_dict
from asr_ttl_mtl_tpu.mtl import MultiTaskSpeechDataset as JDataset
from asr_ttl_mtl_tpu.mtl import MultiTaskTrainer as JTrainer
from asr_ttl_mtl_tpu.mtl import TrainingConfig as JConfig
from asr_ttl_mtl_tpu.mtl import collate as jcollate
from asr_ttl_mtl_tpu.mtl.dataset import audio_buckets
from asr_ttl_mtl_tpu.ops import decode_attention as JD
from asr_ttl_mtl_tpu.ops import flash_attention as JF
from asr_ttl_mtl_tpu_torch import decoding as PDec
from asr_ttl_mtl_tpu_torch import ops
from asr_ttl_mtl_tpu_torch.models import ModelDimensions, WhisperModel, state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of
from asr_ttl_mtl_tpu_torch.mtl.trainer import classifier_state_from_jax
from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import decode_attention as PD
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF

from torch_port_helpers import (DEBUG_DIMS, SMALL, TRAIN_CONFIG, jax_dims, model_pair, np_tree, waveforms,
                                write_wav_dataset)

ATOL = 1e-5  # fp32 both sides; only the order of the sums differs (as test_torch_head_width_wide.py)
LP_TOL = 1e-4  # avg_logprob and no_speech_prob (as test_torch_head_width_wide.py)
REL = 1e-4  # the loss and gradient norms (as test_torch_head_width_train.py)
SMEM = 227 * 1024  # a block's shared memory on the H100
DECODE_WIDTHS = [264, 384, 768, 3, 20, 75, 100]  # classes 512 and 768, and widths off a multiple of 8
OFF_WIDTHS = [3, 20, 75, 100]  # rows of 6, 40, 150 and 200 bf16 bytes: no 16-byte stride
# 2 heads of 75 (d 150), 2 + 2 layers, and 2 heads of 384 (d 768), 1 + 1 layers, fp32
D150 = dict(n_audio_state=150, n_audio_head=2, n_text_state=150, n_text_head=2)
D768 = dict(n_audio_state=768, n_audio_head=2, n_audio_layer=1, n_text_state=768, n_text_head=2, n_text_layer=1)
BENCH = dict(language="en", without_timestamps=True, sample_len=8, suppress_tokens="-1,50257", fp16=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=0)


# ------------------------------------------ the checks and the plans ------


@pytest.mark.parametrize("dh", range(264, 769, 8))
def test_decode_plans_fit_from_264_to_768(dh):
    """decode_class puts 264-512 in the class of 512 and 520-768 in 768, and
    K2's plan and K1's shared memory fit a CTA there in both dtypes at
    groups 1, 5, 9 and 16 (and 40, which above 256 takes a CTA a 16-row
    chunk): K2 over one window, 8 and 32 windows (1500 keys) and a 448-row
    self cache; K1 at every key block `_i8_blocks` gives (128-1024)."""
    cls = ops.decode_class(dh)
    assert cls == (512 if dh <= 512 else 768)
    n_head = max(1, 1280 // dh)
    for itemsize in (2, 4):
        for batch, n_keys in ((1, 1500), (8, 1500), (32, 1500), (8, 448)):
            for group in (1, 5, 9, 16, 40):
                split = PD.k2_plan(batch, n_head, n_keys, group, itemsize, cls)
                assert PD.k2_smem_bytes(group, -(-n_keys // split), itemsize, cls) <= SMEM
    assert PD.k2_cta_rows(40, cls) == 16 and PD.k2_cta_rows(16, cls) == 16 and PD.k2_cta_rows(40, 256) == 40
    for group in (1, 5, 9, 16):
        for tk_blk in (128, 256, 512, 1024):
            assert PD.k1_smem_bytes(min(group, PD.K1_ROWS), tk_blk, cls) <= SMEM


@pytest.mark.parametrize("dh", [1, 3, 4, 20, 75, 100, 129, 300, 700, 767])
def test_widths_off_a_multiple_of_8_are_served(dh):
    """A width off a multiple of 8: K1 and K2 run it in the smallest class at
    or above it, K7 and K8 at kernel_width(dh), dh rounded up to 8."""
    width = ops.kernel_width(dh)
    assert width % 8 == 0 and dh < width < dh + 8
    assert ops.decode_class(dh) == min(c for c in ops.DECODE_CLASSES if c >= dh)
    assert ops.forward_width(dh) == (ops.width_class(width) if width <= 128 else 0)


# ----------------------------------------------------- K2 and K1 ------


@pytest.mark.parametrize("dh", DECODE_WIDTHS)
@pytest.mark.parametrize("group,valid", [(1, 100), (5, 37)])
def test_k2_and_k1_plain_match_jax(dh, group, valid):
    """K2 over fp32 caches and K1 over int8 caches (tk_blk 128) at 2 heads of
    dh, keys valid to 100 or 37 of 128: the plain K2 within 1e-5 of JAX's
    kernel in interpret mode, the plain K1 within its flip bound plus
    1e-5."""
    n_head, b, tk = 2, 2, 128
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


# ------------------------------------------------- K7-lse and K8 ------


@functools.lru_cache(maxsize=None)
def _flash_case(dh, causal, q_offset, kv_valid_len):
    """Seeded (bh 2, tq 40, tk 64) inputs at head width dh, the keyword
    arguments, and the JAX package's flash_attention (out, lse) and
    flash_attention_bwd (dq, dk, dv) on them in interpret mode; shared by
    the plain and the padded-route tests."""
    bh, tq, tk = 2, 40, 64
    q, k, v, g = _inputs([(bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh)], seed=dh + 3)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention(q, k, v, return_lse=True, interpret=True, **kw)
        jgrads = JF.flash_attention_bwd(q, k, v, jout, jlse, g, interpret=True, **kw)
    return (q, k, v, g), kw, (np.asarray(jout), np.asarray(jlse)), tuple(np.asarray(x) for x in jgrads)


@pytest.mark.parametrize("dh", OFF_WIDTHS)
@pytest.mark.parametrize("causal,q_offset,kv_valid_len", [(True, 7, None), (False, 0, 50)], ids=["causal", "cross"])
def test_k7_lse_and_k8_plain_match_jax(dh, causal, q_offset, kv_valid_len):
    """The plain K7 with lse and the plain K8 at a width off a multiple of 8,
    against the JAX package's flash_attention and flash_attention_bwd in
    interpret mode (1e-5): causal at a q_offset, and cross over keys valid
    to 50 of 64."""
    (q, k, v, g), kw, (jout, jlse), jgrads = _flash_case(dh, causal, q_offset, kv_valid_len)
    pout, plse = PF.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    _close(pout, jout)
    _close(plse, jlse)
    for a, c in zip(PF.flash_attention_bwd(_t(q), _t(k), _t(v), _t(jout), _t(jlse), _t(g), **kw), jgrads):
        _close(a, c)


class PlainKernelLib:
    """The fp32 C entries of K7 and K8 as the plain versions, reading and
    writing the tensors at the addresses the wrapper passes (CPU memory), so
    the wrappers' own card route runs around them; records each call's
    head width, which the kernels require to be a multiple of 8."""

    def __init__(self):
        self.widths = []

    @staticmethod
    def _at(ptr, shape):
        n = int(np.prod(shape))
        return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)).reshape(shape))

    def flash_fwd_f32(self, qp, kp, vp, op, lsep, bh, tq, tk, dh, kv_len, causal, q_offset, scale, stream):
        self.widths.append(dh)
        q, k, v = (self._at(p, (bh, t, dh)) for p, t in ((qp, tq), (kp, tk), (vp, tk)))
        out, lse = PF.flash_attention_plain(q, k, v, causal=bool(causal), q_offset=q_offset, kv_valid_len=kv_len,
                                            scale=scale, return_lse=True)
        self._at(op, (bh, tq, dh)).copy_(out)
        if lsep:
            self._at(lsep, (bh, tq, 1)).copy_(lse)
        return 0

    def flash_bwd_f32(self, qp, kp, vp, gp, lsep, deltap, dqp, dkp, dvp, bh, tq, tk, dh, kv_len, causal, q_offset,
                      scale, stream):
        self.widths.append(dh)
        q, k, v, g = (self._at(p, (bh, t, dh)) for p, t in ((qp, tq), (kp, tk), (vp, tk), (gp, tq)))
        lse, delta = self._at(lsep, (bh, tq, 1)), self._at(deltap, (bh, tq, 1))
        mask = PF._mask(tq, tk, kv_len, bool(causal), q_offset, q.device)
        for p, t, x in zip((dqp, dkp, dvp), (tq, tk, tk), PF._bwd_plain(q, k, v, g, lse, delta, mask, scale)):
            self._at(p, (bh, t, dh)).copy_(x)
        return 0


@pytest.mark.parametrize("dh", OFF_WIDTHS)
@pytest.mark.parametrize("causal,q_offset,kv_valid_len", [(True, 7, None), (False, 0, 50)], ids=["causal", "cross"])
def test_padded_route_matches_jax(monkeypatch, dh, causal, q_offset, kv_valid_len):
    """The flash wrappers' card route at a width off a multiple of 8, with
    the plain version in the kernel's place: q, k, v (and dO) go to the
    kernel at kernel_width(dh) with zero columns and the true width's
    scale, and the dh columns that come back (out, lse, dq, dk, dv) agree
    with the JAX package at dh within 1e-5; one launch each."""
    lib = PlainKernelLib()
    monkeypatch.setattr(PF, "on_card", lambda *a: True)
    monkeypatch.setattr(PF._cuda, "lib", lambda name: lib)
    monkeypatch.setattr(PF._cuda, "stream_handle", lambda device: 0)
    reset_launch_counts()
    (q, k, v, g), kw, (jout, jlse), jgrads = _flash_case(dh, causal, q_offset, kv_valid_len)
    pout, plse = PF.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    assert tuple(pout.shape) == q.shape and pout.is_contiguous()
    _close(pout, jout)
    _close(plse, jlse)
    grads = PF.flash_attention_bwd(_t(q), _t(k), _t(v), pout, plse, _t(g), **kw)
    for a, c in zip(grads, jgrads):
        assert tuple(a.shape) == c.shape
        _close(a, c)
    assert lib.widths == [ops.kernel_width(dh)] * 2
    assert {n: c for n, c in LAUNCHES.items() if c} == {"flash_attention_lse_f32": 1, "flash_attention_bwd_f32": 1}
    reset_launch_counts()


# -------------------------------------------- the slice at heads of 75 ------


def _decode_against_jax(jmodel, tmodel, mel, opts):
    JW.set_decode_kernel("interpret")
    try:
        jres = JTask(jmodel, JOptions(**opts)).run(jnp.asarray(mel))
    finally:
        JW.set_decode_kernel("auto")
    tres = PDec.DecodingTask(tmodel, PDec.DecodingOptions(**opts)).run(torch.from_numpy(mel.copy()))
    assert len(jres) == len(tres) == mel.shape[0]
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens and t.text == j.text
        assert abs(t.avg_logprob - j.avg_logprob) <= LP_TOL
        assert abs(t.no_speech_prob - j.no_speech_prob) <= LP_TOL


def _counted(monkeypatch, name):
    """Count the calls of PF.<name> (the wrapper `qkv_attention` reaches)."""
    calls = []
    real = getattr(PF, name)
    monkeypatch.setattr(PF, name, lambda *a, **kw: (calls.append(a[0].shape), real(*a, **kw))[1])
    return calls


@pytest.fixture(scope="module")
def window75():
    jmodel, tmodel = model_pair(seed=7, **D150)
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(2, 2 * 96, seed=12), use_pallas=False))
    return jmodel, tmodel, mel


@pytest.mark.parametrize("opts", [dict(BENCH, kv_quant=False), dict(BENCH, kv_quant=True),
                                  dict(language="en", sample_len=8, fp16=False, beam_size=3)],
                         ids=["greedy-float-kv", "greedy-kv_quant", "beam3"])
def test_decoding_task_matches_jax_at_2_heads_of_75(window75, monkeypatch, opts):
    """2 heads of 75 (d 150): no K5 shape (75 is off a multiple of 8), so the
    encoder runs K7 over split heads (its plain version here, counted) and
    the steps K2 or K1 in the class of 128; the same tokens and text as the
    JAX package, avg_logprob and no_speech_prob within 1e-4."""
    jmodel, tmodel, mel = window75
    k7 = _counted(monkeypatch, "flash_attention")
    k5 = _counted(monkeypatch, "flash_attention_mh")
    _decode_against_jax(jmodel, tmodel, mel, opts)
    assert k7 and {s[-1] for s in k7} == {75} and not k5


def test_decoding_task_matches_jax_at_2_heads_of_384(monkeypatch):
    """2 heads of 384 (d 768, 1 + 1 layers), greedy with float KV: the
    encoder on K5 (its plain version here) and the steps on K2 in the class
    of 512; the JAX package's tokens, text and scores."""
    jmodel, tmodel = model_pair(seed=8, **D768)
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(1, 2 * 96, seed=13), use_pallas=False))
    k5 = _counted(monkeypatch, "flash_attention_mh")
    _decode_against_jax(jmodel, tmodel, mel, dict(BENCH, kv_quant=False))
    assert k5 and {s[-1] for s in k5} == {768}


def test_train_step_matches_jax_at_2_heads_of_75(tmp_path):
    """One MultiTaskTrainer step from the same carried weights, batch and
    dropout keep-mask at 2 heads of 75 (d 150, K7-lse and K8 through the
    wrappers' plain versions here): the loss and every group's gradient
    norm within 1e-4 of the JAX step's."""
    d = D150["n_audio_state"]
    cfg = dict(TRAIN_CONFIG, debug_dims=dict(DEBUG_DIMS, **D150))
    jtr = JTrainer(JConfig(**cfg, save_dir=str(tmp_path / "jax")), verbose=False)
    ptr = MultiTaskTrainer(TrainingConfig(**cfg, device="cpu", save_dir=str(tmp_path / "port")), verbose=False)
    ptr.load_state(state_dict_from_jax_params(np_tree(jtr.model.params), jtr.model.dims),
                   classifier_state_from_jax(np_tree(jtr.classifier_params)))
    ds = JDataset(write_wav_dataset(tmp_path, n=4, seed=75), JConfig(**cfg))
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


@pytest.mark.parametrize("geometry", [D150, D768], ids=["d150-2x75", "d768-2x384"])
def test_state_dict_from_jax_params_matches_export(geometry):
    """The port's carrier gives the JAX package's own export, key for key
    and value for value, and loads into the port's model at this width (a
    vocabulary of 1000: the carrier moves the embedding as it is)."""
    geometry = dict(geometry, n_vocab=1000)
    dims = jax_dims(**geometry)
    rng = np.random.RandomState(geometry["n_audio_state"])
    shapes = jax.eval_shape(lambda key: JW.init_params(key, dims), jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: rng.randn(*x.shape).astype(x.dtype), shapes)
    got, want = state_dict_from_jax_params(params, dims), export_torch_state_dict(params, dims)
    assert set(want) <= set(got)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    model = WhisperModel(ModelDimensions(**{**SMALL, **geometry}), compute_dtype=torch.float32)
    model.load_state_dict(got)  # strict: every key the port's model has, at its shape
