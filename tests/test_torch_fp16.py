"""fp16 serving: the port's decode of an fp16 model against the JAX
package's (`compute_dtype=jnp.float16`, the same carried weights) in
greedy, greedy with int8 KV, beam 3 and greedy with the W8A8 encoder under
the K14 switch; the logit fill in each dtype (JAX's `jnp.where(mask, -1e9,
logits)` casts -1e9 into the logits' dtype: -inf in fp16, bf16 and fp32
unchanged); the plain K1, K2, K3, K5 (route A's width 80 and route B's 256),
K7, K9 / K10 and K14 against the JAX kernels in interpret mode on fp16
inputs; the dtype gate (the serving kernels pick their `_f16` symbols and
counts, the training kernels and the trainer refuse fp16); and, marked
`cuda`, each fp16 kernel against its plain version on the card."""

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
from asr_ttl_mtl_tpu.models.registry import WhisperModel as JaxWhisperModel
from asr_ttl_mtl_tpu.ops import decode_attention as JD
from asr_ttl_mtl_tpu.ops import flash_attention as JF
from asr_ttl_mtl_tpu.ops import int8_mlp as JM
from asr_ttl_mtl_tpu.ops.pallas_topk import topk_logprobs_pallas, topk_pallas
from asr_ttl_mtl_tpu_torch import decode_steps as PS
from asr_ttl_mtl_tpu_torch import decoding as PDec
from asr_ttl_mtl_tpu_torch import ops
from asr_ttl_mtl_tpu_torch.models import WhisperModel, state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.models import whisper as PW
from asr_ttl_mtl_tpu_torch.models.dims import ModelDimensions as TorchDims
from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import decode_attention as PD
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF
from asr_ttl_mtl_tpu_torch.ops import int8_mlp as PM
from asr_ttl_mtl_tpu_torch.ops import topk as PT

from torch_port_helpers import SMALL, cuda_device, jax_dims, np_tree, waveforms  # noqa: F401

F16 = torch.float16
# avg_logprob and no_speech_prob of the fp16 decodes: JAX and the port sum
# and round in other orders (1.2e-4 apart measured at SMALL)
LP_TOL = 1e-3
# the plain fp16 kernels against the JAX kernels on the same fp16 inputs:
# both take fp32 scores and sums and round p and the output to fp16 at the
# same places, so they differ by the order of the sums: a rounding of the
# fp16 output (2^-11 relative) or of p, within 2^-9 of the largest output
REL = 2.0**-9


def _f16(a):
    """A numpy array -> (fp16 numpy, fp16 torch, fp16 jax), one set of values."""
    h = np.asarray(a, np.float32).astype(np.float16)
    return h, torch.from_numpy(h.copy()), jnp.asarray(h)


def _inputs(shapes, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return [_f16(rng.randn(*s) * scale) for s in shapes]


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


# --------------------------------------------------- the decode repair ------


@pytest.fixture(scope="module")
def pair16():
    """(JAX model, port model) in fp16 with the same carried weights, and a
    2-window mel."""
    dims = jax_dims()
    params = JW.init_params(jax.random.PRNGKey(0), dims)
    jmodel = JaxWhisperModel(dims=dims, params=params, compute_dtype=jnp.float16)
    tmodel = WhisperModel(TorchDims(**SMALL), compute_dtype=F16)
    tmodel.load_state_dict(state_dict_from_jax_params(np_tree(params), dims))
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(2, 2 * 96, seed=5), use_pallas=False))
    return jmodel, tmodel.eval().requires_grad_(False), mel


GREEDY = dict(language="en", sample_len=8)


@pytest.mark.parametrize("opts", [GREEDY, dict(GREEDY, kv_quant=True), dict(GREEDY, beam_size=3),
                                  dict(GREEDY, int8_encoder=True)],
                         ids=["greedy", "greedy-kv_quant", "beam3", "greedy-int8_encoder-k14"])
def test_fp16_decode_matches_jax(pair16, opts):
    """The port's DecodingTask on an fp16 model gives the JAX package's
    tokens and text, avg_logprob and no_speech_prob within LP_TOL (the JAX
    decode kernels in interpret mode; with int8_encoder the K14 switch is on
    in both, and on the CPU both encoders run the linear_i8 composition, as
    JAX's gate takes its kernel on a TPU only)."""
    jmodel, tmodel, mel = pair16
    JW.set_decode_kernel("interpret")
    JW.set_int8_mlp_kernel("auto")
    PW.set_int8_mlp_kernel("auto")
    try:
        jres = JTask(jmodel, JOptions(**opts)).run(jnp.asarray(mel))
        task = PDec.DecodingTask(tmodel, PDec.DecodingOptions(**opts))
        assert task.compute_dtype == F16
        tres = task.run(torch.from_numpy(mel.copy()))
    finally:
        JW.set_decode_kernel("auto")
        JW.set_int8_mlp_kernel("off")
        PW.set_int8_mlp_kernel("off")
    assert len(jres) == len(tres) == 2
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens and t.text == j.text
        assert abs(t.avg_logprob - j.avg_logprob) <= LP_TOL, (t.avg_logprob, j.avg_logprob)
        assert abs(t.no_speech_prob - j.no_speech_prob) <= LP_TOL


def test_fill_is_minus_inf_in_fp16_and_unchanged_in_bf16_and_fp32(monkeypatch):
    """The fill JAX's weakly typed -1e9 takes in each dtype; in bf16 and
    fp32 every filter pass gives the bits the -1e9 fill gave."""
    assert PS.neg_fill(F16) == float("-inf")
    assert PS.neg_fill(torch.float32) == -1e9
    assert PS.neg_fill(torch.bfloat16) == float(jnp.asarray(-1e9, jnp.bfloat16).astype(jnp.float32))
    assert PS.neg_fill(F16) == float(jnp.where(True, -1e9, jnp.zeros((), jnp.float16)))
    cfg = PS.FilterConfig(n_vocab=300, eot=250, timestamp_begin=260, no_timestamps=255, blank_tokens=(220, 250),
                          suppress_tokens=(1, 7, 251), suppress_blank=True, apply_timestamp_rules=True,
                          max_initial_timestamp_index=5)
    rng = np.random.RandomState(0)
    state = [torch.tensor(x) for x in ([-1, 265, 3], [-1, 264, 265], [-1, 265, 264])]
    for dt, ints in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
        logits = torch.from_numpy(rng.randn(3, 300).astype(np.float32) * 4).to(dt)
        for step in (0, 1, 3):
            got = PS._apply_filters(cfg, logits, step, *state)
            with monkeypatch.context() as m:
                m.setattr(PS, "neg_fill", lambda dtype: -1e9)  # the fill before fp16
                old = PS._apply_filters(cfg, logits, step, *state)
            assert torch.equal(got.view(ints), old.view(ints))
    got = PS._apply_filters(cfg, torch.from_numpy(rng.randn(3, 300).astype(np.float16)), 0, *state)
    assert bool(torch.isinf(got[:, :260]).all()) and not bool(torch.isnan(got).any())


# ------------------------------------------- the plain kernels in fp16 ------


@pytest.mark.parametrize("group,valid", [(1, None), (5, 37)])
def test_k2_and_k1_plain_match_jax_in_fp16(group, valid):
    """K2 over fp16 caches and K1 with fp16 queries over int8 caches
    (tk_blk 128), 2 heads of 64; K1 within the plain version's flip bound
    plus REL."""
    n_head, b, tk, d = 2, 2, 128, 128
    (q, tq, jq), (ck, tck, jck), (cv, tcv, jcv) = _inputs([(b * group, 1, d), (2, b, tk, d), (2, b, tk, d)],
                                                          seed=group, scale=1.0)
    kw = dict(scale=64**-0.5, valid_upto=valid, group=group)
    want = JD.decode_attention(jq, jck, jcv, 1, n_head, interpret=True, **kw)
    got = PD.decode_attention(tq, tck, tcv, 1, n_head, **kw)
    assert got.dtype == F16 and want.dtype == jnp.float16
    _close(got, want)
    ki, ks = JD.quantize_kv_rows(jnp.asarray(ck, jnp.float32))
    vi, vs = JD.quantize_kv_rows(jnp.asarray(cv, jnp.float32))
    want = JD.decode_attention_i8(jq, ki, ks, vi, vs, 1, n_head, interpret=True, **kw)
    t8 = [torch.from_numpy(np.array(x)) for x in (ki, ks, vi, vs)]
    got, flip = PD.decode_attention_i8_plain(tq, *t8, 1, n_head, return_flip_bound=True, **kw)
    assert got.dtype == F16 and want.dtype == jnp.float16
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert np.all(diff <= REL * np.abs(np.asarray(want, np.float32)).max() + flip.numpy())


def test_k3_plain_matches_jax_in_fp16():
    """K3 at 2 heads of 64 over keys valid to 50 of 64."""
    (q, tq, jq), (k, tk, jk), (v, tv, jv) = _inputs([(2, 40, 128), (2, 64, 128), (2, 64, 128)], seed=3)
    kw = dict(n_head=2, kv_valid_len=50, scale=0.125)
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention_h2(jq, jk, jv, return_lse=False, interpret=True, **kw)
    got = PF.flash_attention_h2(tq, tk, tv, **kw)
    assert got.dtype == F16
    _close(got, want)


@pytest.mark.parametrize("dh", [80, 256], ids=["route-A-80", "route-B-256"])
def test_k5_plain_matches_pallas_in_fp16(dh):
    """K5 over the natural layout at 3 heads of dh (k5_plan: route A at 80,
    route B at 256), keys valid to 50 of 64."""
    n_head, b, tq, tk = 3, 2, 32, 64
    d = n_head * dh
    assert PF.k5_plan(dh, tq).route == ("A" if dh == 80 else "B")
    (q, tq_, jq), (k, tk_, jk), (v, tv, jv) = _inputs([(b, tq, d), (b, tk, d), (b, tk, d)], seed=dh)
    kw = dict(n_head=n_head, kv_valid_len=50, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention_mh(jq, jk, jv, interpret=True, **kw)
    got = PF.flash_attention_mh(tq_, tk_, tv, **kw)
    assert got.dtype == F16
    _close(got, want)


@pytest.mark.parametrize("dh", [64, 256])
def test_k7_plain_matches_jax_in_fp16(dh):
    """K7, causal at q_offset 7 with keys valid to 60 (the prompted
    prefill's pattern), at dh 64 and 256."""
    bh, tq, tk = 2, 40, 64
    (q, tq_, jq), (k, tk_, jk), (v, tv, jv) = _inputs([(bh, tq, dh), (bh, tk, dh), (bh, tk, dh)], seed=dh + 1)
    kw = dict(causal=True, q_offset=7, kv_valid_len=60, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention(jq, jk, jv, interpret=True, **kw)
    got = PF.flash_attention(tq_, tk_, tv, **kw)
    assert got.dtype == F16
    _close(got, want)


def _rows16(b, v, seed):
    """fp16 logits as the beam step sees them at step 0: the filters' -inf
    fill on suppressed and non-timestamp lanes, a tie at the row max, a row
    with fewer finite entries than k."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, v) * 3).astype(np.float16)
    x[:, 3 : v // 2] = -np.inf
    x[:, [v // 2 + 1, v - 1]] = x.max(axis=1, keepdims=True) + 1
    x[1] = -np.inf
    x[1, [9, v - 3]] = 2.0
    return x


@pytest.mark.parametrize("b,v,k", [(5, 1000, 6), (3, 51865, 6), (4, 517, 1)])
def test_k9_and_k10_plain_match_pallas_on_fp16_rows_with_minus_inf(b, v, k):
    """Indices exact; K9's values within 1e-6 (+1e-6 relative) of the
    Pallas kernel's, -inf where it gives -inf; K10's bit for bit."""
    x = _rows16(b, v, seed=v + k)
    xt, xj = torch.from_numpy(x.copy()), jnp.asarray(x)
    want_v, want_i = topk_logprobs_pallas(xj, k, interpret=True)
    got_v, got_i = PT.topk_logprobs(xt, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    got_v, want_v = got_v.numpy(), np.asarray(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), np.isfinite(want_v))
    fin = np.isfinite(want_v)
    np.testing.assert_allclose(got_v[fin], want_v[fin], atol=1e-6, rtol=1e-6)
    want_v, want_i = topk_pallas(xj, k, interpret=True)
    got_v, got_i = PT.topk(xt, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v, np.float32))


def test_k14_plain_matches_pallas_in_fp16():
    """K14 with fp16 activations against the Pallas kernel (interpret) on the
    same fp16 rows and int8 weights: the int8 intermediates equal but for
    one-step flips at rounding midpoints, the output within the bounds of
    the bf16 case of tests/test_torch_int8_mlp.py."""
    n, d, h = 256, 256, 1024
    rng = np.random.default_rng(0)
    w1 = jnp.asarray(rng.standard_normal((d, h), dtype=np.float32) * 0.05)
    b1 = jnp.asarray(rng.standard_normal(h, dtype=np.float32) * 0.1)
    w2 = jnp.asarray(rng.standard_normal((h, d), dtype=np.float32) * 0.05)
    b2 = jnp.asarray(rng.standard_normal(d, dtype=np.float32) * 0.1)
    x, xt, xj = _f16(rng.standard_normal((2, n // 2, d), dtype=np.float32) * 0.5)
    w1q, s1 = JW._quant_colwise_sym(w1)
    w2q, s2 = JW._quant_colwise_sym(w2)
    want = np.asarray(JM.int8_mlp(xj, w1q, s1, b1, w2q, s2, b2, interpret=True), np.float32)

    def t(a):
        return torch.from_numpy(np.array(a))

    got, qx, qg, _ = PM.int8_mlp_plain(xt, t(w1q).T.contiguous(), t(s1).reshape(-1), t(b1), t(w2q).T.contiguous(),
                                       t(s2).reshape(-1), t(b2), return_int8=True)
    assert got.dtype == F16
    jqx, _ = JM._quant_rows(xj.reshape(-1, d).astype(jnp.float32))
    assert np.array_equal(qx.numpy(), np.asarray(jqx))
    got = got.float().numpy()
    diff = np.abs(got - want)
    scale = np.abs(want).mean() + 1e-6
    assert diff.max() / scale < 0.12 and diff.mean() / scale < 0.02, (diff.max(), diff.mean(), scale)
    assert (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)) > 0.9995


# ----------------------------------------------------------- the gates ------


class FakeLib:
    """Records the C symbol a wrapper calls; every call returns 0."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def fn(*args):
            self.called.append(name)
            return 0

        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers take their card path on CPU tensors, into a FakeLib."""
    lib = FakeLib()
    for mod in (PF, PM, PD, PT):
        monkeypatch.setattr(mod._cuda, "lib", lambda name: lib)
        monkeypatch.setattr(mod._cuda, "stream_handle", lambda device: 0)
    for mod in (PF, PM):
        monkeypatch.setattr(mod, "on_card", lambda *a: True)
    monkeypatch.setattr(PT, "_card_limits", lambda index: (132, 16))
    reset_launch_counts()
    yield lib
    reset_launch_counts()


def test_kernel_dtype_gives_f16_for_the_serving_kernels_and_refuses_training():
    x = torch.zeros(2, dtype=F16)
    for name in ops.F16_KERNELS:
        assert ops.kernel_dtype(name, [x]) == "f16"
    assert ops.F16_KERNELS == {"decode_attention_i8", "decode_attention", "flash_attention_h2",
                               "flash_attention_mh", "flash_attention", "topk_logprobs", "topk", "int8_mlp"}
    for name in ("flash_attention_h2_lse", "flash_attention_h2_bwd", "flash_attention_lse", "flash_attention_bwd"):
        with pytest.raises(TypeError, match="fp16 training slice"):
            ops.kernel_dtype(name, [x])
    with pytest.raises(TypeError, match="of one dtype"):
        ops.kernel_dtype("decode_attention", [x, x.bfloat16()])
    assert {f"{n}_f16" for n in ops.F16_KERNELS} <= set(LAUNCHES)


def test_flash_serving_wrappers_take_fp16_and_training_ones_refuse(fake_card):
    """K3, K5 (both routes) and K7 launch their `_f16` symbols and count
    under `<name>_f16`; K3-lse, K6, K7-lse and K8 raise naming the training
    slice, launching nothing."""
    z = torch.zeros
    q, kv = z((2, 20, 128), dtype=F16), z((2, 30, 128), dtype=F16)
    wide = z((2, 20, 512), dtype=F16)
    qs, ks = z((4, 20, 64), dtype=F16), z((4, 30, 64), dtype=F16)
    assert PF.flash_attention_h2(q, kv, kv, n_head=2).dtype == F16
    assert PF.flash_attention_mh(z((2, 20, 160), dtype=F16), z((2, 30, 160), dtype=F16), z((2, 30, 160), dtype=F16),
                                 n_head=2).dtype == F16
    assert PF.flash_attention_mh(wide, wide, wide, n_head=2).dtype == F16
    assert PF.flash_attention(qs, ks, ks, causal=True, q_offset=10).dtype == F16
    assert fake_card.called == ["flash_h2_fwd_f16", "flash_mh_fwd_f16", "flash_mh_fwd_f16", "flash_fwd_f16"]
    assert {k: n for k, n in LAUNCHES.items() if n} == {"flash_attention_h2_f16": 1, "flash_attention_mh_f16": 2,
                                                        "flash_attention_f16": 1}
    res, lse = z((1, 2, 20, 2)), z((4, 20, 1))
    for call in (lambda: PF.flash_attention_h2(q, kv, kv, n_head=2, return_lse=True),
                 lambda: PF.flash_attention_h2_bwd(q, kv, kv, res, res, q, n_head=2),
                 lambda: PF.flash_attention(qs, ks, ks, return_lse=True),
                 lambda: PF.flash_attention_bwd(qs, ks, ks, qs, lse, qs, causal=True)):
        with pytest.raises(TypeError, match="fp16 training slice"):
            call()
    assert len(fake_card.called) == 4


def test_decode_topk_and_k14_wrappers_take_fp16(fake_card, monkeypatch):
    """K2, K1, K9, K10 and K14 (both routes) launch their `_f16` symbols and
    count under `<name>_f16`."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))  # the CPU tensors pass as the card's
    q = torch.zeros((10, 1, 128), dtype=F16)
    cache = torch.zeros((2, 2, 128, 128), dtype=F16)
    assert PD._launch_k2(q, cache, cache, 1, 2, 0.125, None, 5).dtype == F16
    c8, sc = torch.zeros((2, 2, 128, 128), dtype=torch.int8), torch.ones((2, 2, 128))
    assert PD._launch_k1(q, c8, sc, c8, sc, 1, 2, 0.125, 100, 5, 128).dtype == F16
    rows = torch.zeros((5, 1000), dtype=F16)
    PT._launch("topk_logprobs", rows, 6)
    PT._launch("topk", rows, 6)
    for d, hidden in ((512, 2048), (1280, 1280)):
        x = torch.zeros((40, d), dtype=F16)
        w1q, w2q = torch.zeros((hidden, d), dtype=torch.int8), torch.zeros((d, hidden), dtype=torch.int8)
        assert PM.int8_mlp(x, w1q, torch.ones(hidden), torch.zeros(hidden), w2q, torch.ones(d),
                           torch.zeros(d)).dtype == F16
    assert fake_card.called == ["decode_attn_f16", "decode_attn_i8_f16", "topk_logprobs_f16", "topk_f16",
                                "int8_mlp_f16", "int8_mlp_mma_f16"]
    assert {k: n for k, n in LAUNCHES.items() if n} == {
        "decode_attention_f16": 1, "decode_attention_i8_f16": 1, "topk_logprobs_f16": 1, "topk_f16": 1,
        "int8_mlp_f16": 2}


def test_trainer_refuses_float16_naming_the_training_slice():
    with pytest.raises(ValueError, match="fp16 training slice"):
        MultiTaskTrainer(TrainingConfig(compute_dtype="float16", device="cpu"))


# ------------------------------------------------------------- the card ----


def _card(shape, gen, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(F16)


@pytest.mark.cuda
def test_fp16_kernels_against_their_plain_versions_on_card(cuda_device):  # noqa: F811
    """Each fp16 kernel against its plain version at the tolerance of its
    bf16 twin (fp16 rounds finer), the same bits on a second launch, and
    one `_f16` launch a call."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)

    def held(name, run, want, tol):
        reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        assert LAUNCHES[f"{name}_f16"] == 1, name
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype and bool(torch.isfinite(g.float()).all()), name
            assert (g.float() - w.float()).abs().max().item() <= tol, name
        again = run()
        for g, a in zip(got if isinstance(got, tuple) else (got,), again if isinstance(again, tuple) else (again,)):
            assert torch.equal(g, a), name

    q, k, v = (_card((4, 300, 512), gen, dev) for _ in range(3))
    kw = dict(n_head=8, kv_valid_len=250, scale=0.125)
    want = PF.flash_attention_h2_plain(q, k, v, **kw)
    held("flash_attention_h2", lambda: PF.flash_attention_h2(q, k, v, **kw), want,
         2.0**-6 * want.float().abs().max().item())
    for d, n_head in ((576, 9), (480, 6), (1280, 5)):  # the class, route A, route B
        q, k, v = (_card((2, 200, d), gen, dev) for _ in range(3))
        kw = dict(n_head=n_head, kv_valid_len=180, scale=(d // n_head) ** -0.5)
        want = PF.flash_attention_mh_plain(q, k, v, **kw)
        held("flash_attention_mh", lambda: PF.flash_attention_mh(q, k, v, **kw), want,
             2.0**-6 * want.float().abs().max().item())
    for dh in (64, 256, 75):
        q, k, v = _card((16, 24, dh), gen, dev), _card((16, 64, dh), gen, dev), _card((16, 64, dh), gen, dev)
        kw = dict(causal=True, q_offset=30, kv_valid_len=60, scale=dh**-0.5)
        want = PF.flash_attention_plain(q, k, v, **kw)
        held("flash_attention", lambda: PF.flash_attention(q, k, v, **kw), want,
             2.0**-6 * want.float().abs().max().item())
    for group, dh in ((1, 64), (5, 64), (5, 256), (1, 75)):
        n_head = 512 // dh if dh != 75 else 8
        d = n_head * dh
        q = _card((4 * group, 1, d), gen, dev)
        ck, cv = _card((2, 4, 448, d), gen, dev), _card((2, 4, 448, d), gen, dev)
        kw = dict(scale=dh**-0.5, valid_upto=300, group=group)
        want = PD.decode_attention_plain(q, ck, cv, 1, n_head, **kw)
        held("decode_attention", lambda: PD.decode_attention(q, ck, cv, 1, n_head, **kw), want,
             2.0**-7 * want.float().abs().max().item())
        args = (*PD.quantize_kv_rows(ck), *PD.quantize_kv_rows(cv))
        want, flip = PD.decode_attention_i8_plain(q, *args, 1, n_head, return_flip_bound=True, **kw)
        ref = want.float().abs()
        tol = ((1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max())
        reset_launch_counts()
        got = PD.decode_attention_i8(q, *args, 1, n_head, **kw)
        assert LAUNCHES["decode_attention_i8_f16"] == 1 and got.dtype == F16
        assert bool(((got.float() - want.float()).abs() <= tol).all())
        assert torch.equal(PD.decode_attention_i8(q, *args, 1, n_head, **kw), got)
    x = torch.from_numpy(_rows16(5, 51865, seed=1)).to(dev)
    for kind, plain, wrapper in (("topk_logprobs", PT.topk_logprobs_plain, PT.topk_logprobs),
                                 ("topk", PT.topk_plain, PT.topk)):
        want_v, want_i = plain(x, 6)
        reset_launch_counts()
        got_v, got_i = wrapper(x, 6)
        assert LAUNCHES[f"{kind}_f16"] == 1 and torch.equal(got_i, want_i)
        fin = torch.isfinite(want_v)
        assert torch.equal(fin, torch.isfinite(got_v))
        assert (got_v[fin] - want_v[fin]).abs().max().item() <= 1e-5
    n, d, h = 4096, 512, 2048
    x = _card((n, d), gen, dev, 0.5)
    w1 = torch.randn((h, d), generator=gen, device=dev) * 0.05
    w2 = torch.randn((d, h), generator=gen, device=dev) * 0.05
    w1q, s1 = PW._quant_rowwise_sym(w1)
    w2q, s2 = PW._quant_rowwise_sym(w2)
    margs = (x, w1q, s1.reshape(-1), torch.zeros(h, device=dev), w2q, s2.reshape(-1), torch.zeros(d, device=dev))
    want = PM.int8_mlp_plain(*margs)
    reset_launch_counts()
    got = PM.int8_mlp(*margs)
    assert LAUNCHES["int8_mlp_f16"] == 1 and got.dtype == F16
    diff = (got.float() - want.float()).abs()
    assert diff.mean().item() < 0.02 * want.float().abs().mean().item()
    assert torch.equal(PM.int8_mlp(*margs), got)


@pytest.mark.cuda
def test_fp16_model_decodes_on_card(cuda_device):  # noqa: F811
    """An fp16 model decodes through DecodingTask on the card in greedy
    (int8 and float KV) and beam 5, launching the fp16 kernels and no bf16
    or fp32 attention kernel."""
    from asr_ttl_mtl_tpu_torch import from_random

    model = from_random("tiny", seed=0, device=cuda_device, dtype=F16)
    mel = torch.randn(2, 80, 3000, device=cuda_device) * 0.3
    for opts, launched in ((dict(kv_quant=True), "decode_attention_i8_f16"),
                           (dict(kv_quant=False), "decode_attention_f16"),
                           (dict(beam_size=5), "topk_logprobs_f16")):
        reset_launch_counts()
        res = PDec.DecodingTask(model, PDec.DecodingOptions(language="en", sample_len=16, **opts)).run(mel)
        assert all(np.isfinite(r.avg_logprob) for r in res)
        assert LAUNCHES[launched] > 0 and LAUNCHES["flash_attention_h2_f16"] > 0, LAUNCHES
        other = {k: n for k, n in LAUNCHES.items() if n and "attention" in k and not k.endswith("_f16")}
        assert not other, other
