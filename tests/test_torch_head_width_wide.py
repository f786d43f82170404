"""Head widths above 128: `ops.decode_class` (K1 and K2 at the class of
256, every multiple of 8 from 136 to 256) and `ops.forward_width` (K7,
K7-lse, K8 and the fp32 K5 on the wide kernels, 136-768), the Python
mirrors of the shared-memory plans (K8's `k8_wide_plan` and
`f32_k8_wide_plan` among them), the plain K7 with lse, K8, K2, K1 and K5
against the JAX functions in interpret mode at dh 136, 200 and 256 (K8
also at 768), and
`DecodingTask.run` against the JAX package at 2 heads of 256 (d 512: the
encoder on K5) and 4 heads of 256 (d 1024: the encoder on K7). The kernels
at these widths on the card are in test_torch_head_width_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu.decoding import DecodingOptions as JOptions
from asr_ttl_mtl_tpu.decoding import DecodingTask as JTask
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.ops import decode_attention as JD
from asr_ttl_mtl_tpu.ops import flash_attention as JF
from asr_ttl_mtl_tpu_torch import decoding as PDec
from asr_ttl_mtl_tpu_torch import ops
from asr_ttl_mtl_tpu_torch.ops import decode_attention as PD
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF

from torch_port_helpers import model_pair, waveforms

ATOL = 1e-5  # fp32 both sides; only the order of the sums differs (as test_torch_head_width_any.py)
LP_TOL = 1e-4  # avg_logprob and no_speech_prob (as test_torch_head_width_any.py)
WIDTHS = [136, 200, 256]  # the class of 256 for K1 / K2; the wide forwards for K7 and K5
SMEM = 227 * 1024  # a block's shared memory on the H100
# 2 heads of 256 (d 512: the encoder on K5), 2 + 2 layers, fp32
D256 = dict(n_audio_state=512, n_audio_head=2, n_text_state=512, n_text_head=2)
# 4 heads of 256 (d 1024, above K5's 768: the encoder on K7), 1 + 1 layers, fp32
D1024 = dict(n_audio_state=1024, n_audio_head=4, n_audio_layer=1, n_text_state=1024, n_text_head=4, n_text_layer=1)
BENCH = dict(language="en", without_timestamps=True, sample_len=12, suppress_tokens="-1,50257", fp16=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=0)


# ------------------------------------------ the checks and the plans ------


@pytest.mark.parametrize("dh", range(136, 257, 8))
def test_decode_class_and_plans_fit_at_256(dh):
    """decode_class puts 136-256 in the class of 256, and K2's plan and K1's
    shared memory at that class fit a CTA for groups 1, 5 and 16 in both
    dtypes: K2 over one window, 8 and 32 windows (1500 keys) and a 448-row
    self cache; K1 at every key block `_i8_blocks` gives (128-1024)."""
    cls = ops.decode_class(dh)
    assert cls == 256
    n_head = max(1, 1280 // dh)
    for itemsize in (2, 4):
        for batch, n_keys in ((1, 1500), (8, 1500), (32, 1500), (8, 448)):
            for group in (1, 5, 16):
                split = PD.k2_plan(batch, n_head, n_keys, group, itemsize, cls)
                assert PD.k2_smem_bytes(group, -(-n_keys // split), itemsize, cls) <= SMEM
    for group in (1, 5, 16):
        for tk_blk in (128, 256, 512, 1024):
            assert PD.k1_smem_bytes(min(group, PD.K1_ROWS), tk_blk, cls) <= SMEM


@pytest.mark.parametrize("dh", range(8, 129, 8))
def test_decode_class_below_136_is_the_width_class(dh):
    assert ops.decode_class(dh) == ops.width_class(dh)
    assert ops.forward_width(dh) == ops.width_class(dh)


@pytest.mark.parametrize("dh", range(136, 769, 8))
def test_f32_wide_plan_fits_at_every_width(dh):
    """The fp32 wide forward's plan: Q of its rows and two 16-key stages fit
    227 KB, 64 rows a CTA up to 544 and 32 above, ceil(dh / 128) slabs; the
    width goes to the wide forwards (forward_width 0) and to K5's route B."""
    p = PF.f32_wide_plan(dh)
    assert p.smem <= PF.K5_SMEM_MAX and p.keys == 16
    assert p.rows == (64 if dh <= 544 else 32) and p.slabs == -(-dh // 128)
    assert ops.forward_width(dh) == 0 and PF.k5_plan(dh, 1536).route == "B"


@pytest.mark.parametrize("dh", [0, -8, 769, 776, 1024, 1280])
def test_decode_class_refuses_the_rest(dh):
    with pytest.raises(ValueError, match="from 1 to 768"):
        ops.decode_class(dh)


@pytest.mark.parametrize("dh", [0, -8, 769, 772, 776, 1024])
def test_forward_width_refuses_the_rest(dh):
    with pytest.raises(ValueError, match="from 1 to 768"):
        ops.forward_width(dh)
    if dh > 128:
        with pytest.raises(ValueError):
            PF.f32_wide_plan(dh)


@pytest.mark.parametrize("dh,refused", [(136, 776), (256, 1024)])
def test_k8_still_refuses_above_128(dh, refused):
    """K8 (the training backward) serves 136-768 on the wide backwards
    (forward_width 0, both plans), and still refuses a width past 768 (776,
    1024), naming 1-768; the wide plans refuse it too."""
    assert ops.forward_width(dh, "flash_attention_bwd") == 0
    assert PF.k8_wide_plan(dh).slabs == PF.f32_k8_wide_plan(dh).slabs == -(-dh // 128)
    with pytest.raises(ValueError, match="from 1 to 768"):
        ops.forward_width(refused, "flash_attention_bwd")
    for plan in (PF.k8_wide_plan, PF.f32_k8_wide_plan):
        with pytest.raises(ValueError, match="from 136 to 768"):
            plan(refused)


@pytest.mark.parametrize("dh", range(136, 769, 8))
def test_k8_wide_plans_fit_at_every_width(dh):
    """K8's wide plans: each kernel's shared memory fits 227 KB with at least
    two stages, and the registers a consumer thread holds for its tiles stay
    in the budget, whatever the width (a CTA owns a 128-column slab): bf16
    dq's slab (64 fp32), S and dP (dq_keys / 2 each) and bf16 dS (dq_keys /
    4) at most 160 of 255; dk/dv's two slabs (128), S^T and dP^T (16 each)
    and bf16 P^T and dS^T (8 each) at most 192 (the fp32 kernels hold the
    same slabs at every width). bf16: 64-key dq boxes up to 704, 32 above;
    fp32: 64 own rows up to 384, 32 above."""
    p, f = PF.k8_wide_plan(dh), PF.f32_k8_wide_plan(dh)
    assert max(p.dq_smem, p.dkv_smem, f.smem) <= PF.K5_SMEM_MAX
    assert p.dq_stages >= 2 and p.dkv_stages >= 2 and p.dkv_queries == 32
    assert p.dq_keys == (64 if dh <= 704 else 32)
    assert f.rows == (64 if dh <= 384 else 32) and f.keys == 16
    assert 64 + p.dq_keys + p.dq_keys // 4 <= 160
    assert 128 + p.dkv_queries + p.dkv_queries // 2 <= 192
    assert p.slabs == f.slabs == -(-dh // 128)


@pytest.mark.parametrize("dh", [0, 8, 128, 132, 772, 776])
def test_k8_wide_plans_refuse_the_rest(dh):
    for plan in (PF.k8_wide_plan, PF.f32_k8_wide_plan):
        with pytest.raises(ValueError, match="multiple of 8 from 136 to 768"):
            plan(dh)


# ----------------------------------------------------------- K7-lse ------


@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("causal,q_offset,kv_valid_len", [(True, 7, 60), (False, 0, 50)], ids=["causal", "cross"])
def test_k7_lse_plain_matches_jax(dh, causal, q_offset, kv_valid_len):
    """K7 with lse at a head width the wide forwards serve: causal at a
    q_offset over keys valid to 60, and cross with keys valid to 50."""
    bh, tq, tk = 2, 40, 64
    q, k, v = _inputs([(bh, tq, dh), (bh, tk, dh), (bh, tk, dh)], seed=dh + tq)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention(q, k, v, return_lse=True, interpret=True, **kw)
        jout_only = JF.flash_attention(q, k, v, interpret=True, **kw)
    pout, plse = PF.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    _close(pout, jout)
    _close(plse, jlse)
    _close(PF.flash_attention(_t(q), _t(k), _t(v), **kw), jout_only)


@pytest.mark.parametrize("dh,bh,tq,tk", [(136, 2, 40, 64), (200, 2, 40, 64), (256, 2, 40, 64), (768, 1, 20, 24)])
@pytest.mark.parametrize("causal,q_offset,kv_valid_len", [(True, 7, None), (False, 0, 50)], ids=["causal", "cross"])
def test_k7_lse_and_k8_plain_match_jax(dh, bh, tq, tk, causal, q_offset, kv_valid_len):
    """The plain K7 with lse and the plain K8 at a head width the wide
    backwards serve, against the JAX package's flash_attention and
    flash_attention_bwd in interpret mode: causal at a q_offset, and cross
    over ragged keys (valid to 50, or to 20 of 24 at 768)."""
    if kv_valid_len is not None:
        kv_valid_len = min(kv_valid_len, tk - 4)
    q, k, v, g = _inputs([(bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh)], seed=dh + tq + 1)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention(q, k, v, return_lse=True, interpret=True, **kw)
        jgrads = JF.flash_attention_bwd(q, k, v, jout, jlse, g, interpret=True, **kw)
    pout, plse = PF.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    _close(pout, jout)
    _close(plse, jlse)
    for a, c in zip(PF.flash_attention_bwd(_t(q), _t(k), _t(v), _t(jout), _t(jlse), _t(g), **kw), jgrads):
        _close(a, c)


# ----------------------------------------------------- K2, K1, K5 ------


@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("group,valid", [(1, None), (5, 37)])
def test_k2_and_k1_plain_match_jax(dh, group, valid):
    """K2 over fp32 caches and K1 over int8 caches (tk_blk 128) at 3 heads
    of dh (odd heads start off a 16-byte boundary at 136 and 200); K1
    within the plain version's flip bound plus fp32 noise."""
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
    """K5 (the fp32 wide forward's plain version) over the natural layout at
    768 // dh heads of dh (d <= 768, as `mh_flash_eligible` asks), keys
    valid to 50."""
    n_head, b, tq, tk = 768 // dh, 2, 32, 64
    d = n_head * dh
    assert PF.mh_flash_eligible(tq, tk, d, n_head, False) == JF.mh_flash_eligible(tq, tk, d, n_head, False) is True
    q, k, v = _inputs([(b, tq, d), (b, tk, d), (b, tk, d)], seed=dh)
    kw = dict(n_head=n_head, kv_valid_len=50, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention_mh(q, k, v, interpret=True, **kw)
    _close(PF.flash_attention_mh(_t(q), _t(k), _t(v), **kw), want)


# ------------------------------------------- the slice at heads of 256 ------


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
def window256():
    jmodel, tmodel = model_pair(seed=5, **D256)
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(2, 2 * 96, seed=10), use_pallas=False))
    return jmodel, tmodel, mel


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float-kv", "kv_quant"])
def test_decoding_task_matches_jax_at_2_heads_of_256(window256, monkeypatch, kv_quant):
    """2 heads of 256 (d 512), greedy: the encoder runs K5 (its plain version
    here) and the steps K2 or K1 at the class of 256; the same tokens and
    text as the JAX package, avg_logprob and no_speech_prob within 1e-4.
    The weights come through `state_dict_from_jax_params` at this width."""
    jmodel, tmodel, mel = window256
    k5 = _counted(monkeypatch, "flash_attention_mh")
    _decode_against_jax(jmodel, tmodel, mel, dict(BENCH, kv_quant=kv_quant))
    assert k5 and {s[-1] for s in k5} == {512}


@pytest.fixture(scope="module")
def window1024():
    jmodel, tmodel = model_pair(seed=6, **D1024)
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(1, 2 * 96, seed=11), use_pallas=False))
    return jmodel, tmodel, mel


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float-kv", "kv_quant"])
def test_decoding_task_matches_jax_at_4_heads_of_256(window1024, monkeypatch, kv_quant):
    """4 heads of 256 (d 1024, 1 + 1 layers, one window), greedy: d is above
    K5's 768, so the encoder runs K7 over split heads (its plain version
    here, counted); the same tokens, text and scores as the JAX package."""
    jmodel, tmodel, mel = window1024
    k7 = _counted(monkeypatch, "flash_attention")
    k5 = _counted(monkeypatch, "flash_attention_mh")
    _decode_against_jax(jmodel, tmodel, mel, dict(BENCH, kv_quant=kv_quant))
    assert k7 and {(s[0], s[-1]) for s in k7} == {(4, 256)} and not k5
