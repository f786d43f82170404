"""The training attention of the port: plain versions of K3 with lse, K6, K7
and K8 against the Pallas kernels (interpret mode on the CPU), the autograd
Functions against autograd of the plain forward, and the CUDA kernels
against their plain versions on the card (marked `cuda`)."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from asr_ttl_mtl_tpu.ops import flash_attention as JF
from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF

from torch_port_helpers import cuda_device  # noqa: F401

ATOL = 1e-5  # fp32 both sides; only the order of the sums differs


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(shapes, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 0.5).astype(dtype) for s in shapes]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=0)


# ------------------------------------------------------- K3 lse and K6 ------

# tq 48 is the token bucket's one ragged q tile; tk 200 with kv_valid_len 130
# leaves a ragged, partly masked last key tile; tq 100 is not a multiple of
# the fp32 kernel's 64-row tile, and keys valid to 97 end inside its second
# key tile
H2_CASES = [(64, 64, None), (64, 200, None), (200, 64, None), (200, 200, 150), (64, 200, 130), (48, 200, 130),
            (48, 48, None), (100, 170, 97)]


@pytest.mark.parametrize("tq,tk,kv_valid_len", H2_CASES)
def test_k3_lse_and_k6_plain_match_pallas(tq, tk, kv_valid_len):
    """d=128, 2 heads (dh 64, one lane tile of 2 heads)."""
    b, d, n_head = 2, 128, 2
    q, k, v, g = _inputs([(b, tq, d), (b, tk, d), (b, tk, d), (b, tq, d)], seed=tq + tk)
    kw = dict(n_head=n_head, kv_valid_len=kv_valid_len, scale=0.125)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention_h2(q, k, v, return_lse=True, interpret=True, **kw)
        delta = np.asarray(JF.flash_attention_h2(q, k, v, return_lse=False, interpret=True, **kw))
        jdelta = (g * delta).reshape(b, tq, 1, 2, 64).sum(-1).transpose(2, 0, 1, 3)
        jgrads = JF.flash_attention_h2_bwd(q, k, v, jlse, jdelta, g, interpret=True, **kw)
    pout, plse = PF.flash_attention_h2(_t(q), _t(k), _t(v), return_lse=True, **kw)
    assert tuple(plse.shape) == (d // 128, b, tq, 2) == tuple(np.asarray(jlse).shape)
    _close(pout, jout)
    _close(plse, jlse)
    _close(PF.h2_delta(_t(g), _t(delta), n_head), jdelta)
    pgrads = PF.flash_attention_h2_bwd(_t(q), _t(k), _t(v), plse, _t(jdelta), _t(g), **kw)
    for name, a, c in zip("dq dk dv".split(), pgrads, jgrads):
        _close(a, c)
    if kv_valid_len is not None:  # masked keys get exactly zero gradient
        assert not pgrads[1][:, kv_valid_len:].any() and not pgrads[2][:, kv_valid_len:].any()


def test_k3_lse_bf16_inputs_match_pallas():
    """bf16 inputs: p and the outputs round to bf16 on both sides, in other
    places; allow 2^-6 of the largest output."""
    b, tq, tk, d = 1, 64, 200, 128
    q, k, v, g = (x.astype(np.float32) for x in _inputs([(b, tq, d), (b, tk, d), (b, tk, d), (b, tq, d)], 5))
    tb = [_t(x).bfloat16() for x in (q, k, v, g)]
    jb = [np.asarray(x.float().numpy()) for x in tb]
    import jax.numpy as jnp

    jbf = [jnp.asarray(x, jnp.bfloat16) for x in jb]
    kw = dict(n_head=2, kv_valid_len=180, scale=0.125)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention_h2(*jbf[:3], return_lse=True, interpret=True, **kw)
        jdelta = (np.asarray(jb[3]) * np.asarray(jout, np.float32)).reshape(b, tq, 1, 2, 64).sum(-1)
        jdelta = jdelta.transpose(2, 0, 1, 3)
        jgrads = JF.flash_attention_h2_bwd(*jbf[:3], jlse, jdelta, jbf[3], interpret=True, **kw)
    pout, plse = PF.flash_attention_h2(*tb[:3], return_lse=True, **kw)
    _close(pout.float(), jout, atol=2.0**-6 * np.abs(np.asarray(jout, np.float32)).max())
    pgrads = PF.flash_attention_h2_bwd(*tb[:3], plse, _t(jdelta), tb[3], **kw)
    for a, c in zip(pgrads, jgrads):
        c = np.asarray(c, np.float32)
        _close(a.float(), c, atol=2.0**-6 * np.abs(c).max())


# ----------------------------------------------------------- K7 and K8 ------

K7_CASES = [  # bh, tq, tk, causal, q_offset, kv_valid_len
    (3, 37, 37, True, 0, None),
    (3, 37, 100, True, 7, None),
    (2, 130, 130, True, 0, None),
    (2, 50, 257, False, 0, 200),
    (2, 48, 300, True, 7, 250),
    (2, 100, 170, True, 9, 97),
]


@pytest.mark.parametrize("bh,tq,tk,causal,q_offset,kv_valid_len", K7_CASES)
def test_k7_and_k8_plain_match_pallas(bh, tq, tk, causal, q_offset, kv_valid_len):
    q, k, v, g = _inputs([(bh, tq, 64), (bh, tk, 64), (bh, tk, 64), (bh, tq, 64)], seed=tq * tk)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=0.125)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention(q, k, v, return_lse=True, interpret=True, **kw)
        jout_nolse = JF.flash_attention(q, k, v, interpret=True, **kw)
        jgrads = JF.flash_attention_bwd(q, k, v, jout, jlse, g, interpret=True, **kw)
    pout, plse = PF.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    assert tuple(plse.shape) == (bh, tq, 1)
    _close(pout, jout)
    _close(plse, jlse)
    _close(PF.flash_attention(_t(q), _t(k), _t(v), **kw), jout_nolse)
    pgrads = PF.flash_attention_bwd(_t(q), _t(k), _t(v), pout, plse, _t(g), **kw)
    for a, c in zip(pgrads, jgrads):
        _close(a, c)


def test_k7_and_k8_bf16_inputs_match_pallas():
    """bf16 inputs, causal with q_offset: p, dS and the outputs round to
    bf16 on both sides, in other places; allow 2^-6 of the largest output."""
    import jax.numpy as jnp

    q, k, v, g = (_t(x).bfloat16() for x in _inputs([(2, 40, 64), (2, 90, 64), (2, 90, 64), (2, 40, 64)], 8))
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v, g))
    kw = dict(causal=True, q_offset=7, kv_valid_len=80, scale=0.125)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention(jq, jk, jv, return_lse=True, interpret=True, **kw)
        jgrads = JF.flash_attention_bwd(jq, jk, jv, jout, jlse, jg, interpret=True, **kw)
    pout, plse = PF.flash_attention(q, k, v, return_lse=True, **kw)
    want = np.asarray(jout, np.float32)
    _close(pout.float(), want, atol=2.0**-6 * np.abs(want).max())
    _close(plse, jlse, atol=1e-4)
    for a, c in zip(PF.flash_attention_bwd(q, k, v, pout, plse, g, **kw), jgrads):
        c = np.asarray(c, np.float32)
        _close(a.float(), c, atol=2.0**-6 * np.abs(c).max())


def test_flash_attention_bhtd_layout():
    q, k, v = _inputs([(2, 3, 40, 64), (2, 3, 40, 64), (2, 3, 40, 64)], seed=9)
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention_bhtd(q, k, v, causal=True, scale=0.125, interpret=True)
    _close(PF.flash_attention_bhtd(_t(q), _t(k), _t(v), causal=True, scale=0.125), want)


# ------------------------------------------------------- autograd Functions --


def _loss(out):
    return (out * torch.cos(out)).sum()  # a non-trivial cotangent


@pytest.mark.parametrize("kv_valid_len", [None, 70])
def test_h2_function_grads_equal_autograd_of_plain(kv_valid_len):
    q, k, v = (_t(x).requires_grad_(True) for x in _inputs([(2, 40, 128), (2, 90, 128), (2, 90, 128)], seed=3))
    kw = dict(n_head=2, kv_valid_len=kv_valid_len, scale=0.125)
    reset_launch_counts()
    got = torch.autograd.grad(_loss(PF.FlashAttentionH2Fn.apply(q, k, v, 2, kv_valid_len, 0.125)), (q, k, v))
    want = torch.autograd.grad(_loss(PF.flash_attention_h2_plain(q, k, v, **kw)), (q, k, v))
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=ATOL, rtol=0)
    assert sum(LAUNCHES.values()) == 0  # CPU tensors never count kernel launches


@pytest.mark.parametrize("causal,q_offset,kv_valid_len", [(True, 0, None), (True, 5, None), (False, 0, 60)])
def test_flash_function_grads_equal_autograd_of_plain(causal, q_offset, kv_valid_len):
    q, k, v = (_t(x).requires_grad_(True) for x in _inputs([(4, 33, 64), (4, 80, 64), (4, 80, 64)], seed=4))
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=0.125)
    got = torch.autograd.grad(_loss(PF.FlashAttentionFn.apply(q, k, v, causal, q_offset, kv_valid_len, 0.125)),
                              (q, k, v))
    want = torch.autograd.grad(_loss(PF.flash_attention_plain(q, k, v, **kw)), (q, k, v))
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=ATOL, rtol=0)


def test_vjp_helpers_take_the_forward_without_grad():
    """Without a gradient the helpers run the forward without lse (what
    evaluation launches); with one, the autograd Function."""
    q, k, v = (_t(x) for x in _inputs([(2, 40, 128), (2, 40, 128), (2, 40, 128)], seed=5))
    qs, ks, vs = (_t(x) for x in _inputs([(4, 40, 64), (4, 40, 64), (4, 40, 64)], seed=6))
    assert PF.flash_attention_h2_vjp(q, k, v, 2, None, 0.125).grad_fn is None
    assert PF.flash_attention_vjp(qs, ks, vs, True).grad_fn is None
    q.requires_grad_(True)
    qs.requires_grad_(True)
    assert type(PF.flash_attention_h2_vjp(q, k, v, 2, None, 0.125).grad_fn).__name__ == "FlashAttentionH2FnBackward"
    assert type(PF.flash_attention_vjp(qs, ks, vs, True).grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert PF.flash_attention_vjp(qs, ks, vs, True).grad_fn is None


# ------------------------------------------------------------ on the card ---


DTYPES = [torch.bfloat16, torch.float32]


def _card_inputs(dev, shapes, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype) for s in shapes]


def _assert_card_close(got, want):
    """bf16: rounding at other places (p, dS, the outputs), 2^-6 of the
    largest output; fp32: sums in another order and 3xTF32 products, 2e-5 of it."""
    assert got.dtype == want.dtype
    rel = 2.0**-6 if got.dtype == torch.bfloat16 else 2e-5
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


def _assert_lse_close(got, want, dtype):
    """lse within 1e-4 in bf16 (as the backward reads it), 2e-5 of its largest in fp32."""
    tol = 1e-4 if dtype == torch.bfloat16 else 2e-5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tq,tk,kv_valid_len", [(200, 200, 150), (48, 1500, None), (448, 1500, None)])
def test_k3_lse_and_k6_kernels_on_card(cuda_device, tq, tk, kv_valid_len, dtype):  # noqa: F811
    q, k, v, g = _card_inputs(cuda_device, [(2, tq, 512), (2, tk, 512), (2, tk, 512), (2, tq, 512)], seed=tq,
                              dtype=dtype)
    kw = dict(n_head=8, kv_valid_len=kv_valid_len, scale=0.125)
    out, lse = PF.flash_attention_h2(q, k, v, return_lse=True, **kw)
    pout, plse = PF.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
    _assert_card_close(out, pout)
    _assert_lse_close(lse, plse, dtype)
    delta = PF.h2_delta(g, pout, 8)
    reset_launch_counts()
    got = PF.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw)
    assert LAUNCHES["flash_attention_h2_bwd" if dtype == torch.bfloat16 else "flash_attention_h2_bwd_f32"] == 1
    for a, c in zip(got, PF.flash_attention_h2_bwd_plain(q, k, v, plse, delta, g, **kw)):
        _assert_card_close(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tq,tk,kv_valid_len", [(48, 1500, None), (64, 1500, None), (200, 1500, None),
                                                (1536, 1536, 1500), (1536, 1500, None), (48, 92, None),
                                                (200, 220, 150), (100, 200, 97)])
def test_k6_kernel_on_card_edges(cuda_device, tq, tk, kv_valid_len, dtype):  # noqa: F811
    """K6 at the edges of its dq and dkv kernels: one (tq <= 64) or two
    consumer warpgroups, a ragged q tile, 1500 keys (a tail key tile of 92),
    kv_valid_len inside a tile and one key tile of 92, and for the fp32
    kernel's 64-row tiles a tq of 100 over keys valid to 97; two launches
    give the same bits, and masked keys get zero dk and dv."""
    q, k, v, g = _card_inputs(cuda_device, [(2, tq, 512), (2, tk, 512), (2, tk, 512), (2, tq, 512)], seed=tq + tk,
                              dtype=dtype)
    kw = dict(n_head=8, kv_valid_len=kv_valid_len, scale=0.125)
    pout, plse = PF.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
    delta = PF.h2_delta(g, pout, 8)
    got = PF.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw)
    again = PF.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw)
    for a, b, c in zip(got, again, PF.flash_attention_h2_bwd_plain(q, k, v, plse, delta, g, **kw)):
        _assert_card_close(a, c)
        assert torch.equal(a, b)
    if kv_valid_len is not None:
        assert not got[1][:, kv_valid_len:].any() and not got[2][:, kv_valid_len:].any()


# bh, tq, tk, causal, q_offset, kv_valid_len: one consumer warpgroup (tq <=
# 64) and two (tq > 128), odd tq (the hpb-1 residual box off a 16-byte
# boundary), tk > tq with q_offset (the prefill), ragged kv_valid_len tiles,
# causal with keys past q_offset + tq that no query sees, fewer residuals
# than one residual box holds, the d=576 encoder and cross shapes at a
# small BH, and a tq of 100 (not a multiple of the fp32 kernel's 64-row
# tile) with keys valid to 97, inside a key tile
K7_CARD_CASES = [
    (1, 20, 40, True, 0, None),
    (16, 64, 64, True, 0, None),
    (8, 448, 448, True, 0, None),
    (8, 37, 448, True, 11, None),
    (8, 100, 300, True, 7, 250),
    (8, 48, 96, True, 48, None),
    (40, 32, 256, True, 0, None),
    (3, 300, 300, True, 0, 290),
    (3, 130, 520, True, 5, None),
    (6, 37, 37, False, 0, None),
    (5, 37, 200, False, 0, 150),
    (6, 200, 300, False, 0, 270),
    (4, 48, 1500, False, 0, None),
    (4, 1536, 1536, False, 0, 1500),
    (3, 100, 170, True, 9, 97),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,tq,tk,causal,q_offset,kv_valid_len", K7_CARD_CASES)
def test_k7_and_k8_kernels_on_card(cuda_device, bh, tq, tk, causal, q_offset, kv_valid_len, dtype):  # noqa: F811
    """K7 (with and without lse) and K8 against their plain versions, bf16
    and fp32 (each launch counted under its dtype's key); a second launch
    gives the same bits, and keys that no query sees (past kv_valid_len, or
    past q_offset + tq when causal) get zero dk and dv."""
    q, k, v, g = _card_inputs(cuda_device, [(bh, tq, 64), (bh, tk, 64), (bh, tk, 64), (bh, tq, 64)], seed=tq + tk,
                              dtype=dtype)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=0.125)
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    reset_launch_counts()
    out, lse = PF.flash_attention(q, k, v, return_lse=True, **kw)
    pout, plse = PF.flash_attention_plain(q, k, v, return_lse=True, **kw)
    _assert_card_close(out, pout)
    nolse = PF.flash_attention(q, k, v, **kw)
    assert LAUNCHES[f"flash_attention_lse{sfx}"] == 1 and LAUNCHES[f"flash_attention{sfx}"] == 1
    _assert_card_close(nolse, pout)
    _assert_lse_close(lse, plse, dtype)
    out2, lse2 = PF.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(nolse, PF.flash_attention(q, k, v, **kw))
    got = PF.flash_attention_bwd(q, k, v, pout, plse, g, **kw)
    again = PF.flash_attention_bwd(q, k, v, pout, plse, g, **kw)
    for a, b, c in zip(got, again, PF.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw)):
        _assert_card_close(a, c)
        assert torch.equal(a, b)
    seen = min(tk if kv_valid_len is None else kv_valid_len, q_offset + tq if causal else tk)
    if seen < tk:
        assert not got[1][:, seen:].any() and not got[2][:, seen:].any()
