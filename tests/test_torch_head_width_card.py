"""The attention kernels on the card, each against its plain version, in
bf16 and in fp32 (the 3xTF32 flash kernels, K2 over fp32 caches, K1 with
fp32 queries), every output bitwise on a second launch. At head widths 32
and 128: K3 with and without lse, K5 (on K3's forward), K6, K7 with and
without lse and K8 over both tile plans, causal, q_offset and a ragged
valid length; K2 and K1 over cross and self caches at groups 1, 5, 16 and
20. At widths below their class (8, 40, 80, 96, 120): K7, K7-lse, K8, the
fp32 K5, K2 and K1. The bf16 K5 on both of its routes (8-120 on K3's
forward over head maps, 136-768 on the wide forward) and its C plan
against `k5_plan`. Above 128 for serving: K7, K7-lse and the fp32 K5 at
136, 200, 256, 384 and 768 on the wide forwards, K2 and K1 at 136, 200 and
256 in the class of 256, and the fp32 wide forward's C plan against
`f32_wide_plan`. Above 128 for training: K8 at 136, 200, 256, 384 and 768
on the wide backwards (and at every multiple of 8 from 136 to 768 on a
small shape), their C plans against `k8_wide_plan` and `f32_k8_wide_plan`.
Every width up to 768: K2 and K1 at 264, 384, 512, 640 and 768 (and
every multiple of 8 from 264 to 768) in the classes of 512 and 768, and
at 4, 20, 75, 100 and 300; K7, K7-lse and K8 at 3, 20, 75, 100, 300 and
700; the C shared-memory plans of K2 and K1 against `k2_smem_bytes` and
`k1_smem_bytes`. A width no kernel serves raises on the card. Marked
`cuda`: they skip where there is no card (`python -m pytest
tests/test_torch_*.py -q -m cuda` on the machine with one). This file
imports no JAX: the plain versions are the reference, and their own tests
hold them to the JAX package (test_torch_head_width.py,
test_torch_head_width_any.py)."""

import pytest
import torch

from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import decode_attention as PD
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF

REL = 2.0**-6  # of the largest output: bf16 rounds p, dS and the outputs at other places (as phase 8 holds them)
FP32_REL = 2e-5  # fp32: the sum order alone (chip_smoke.py's FP32_REL)
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def card():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(card, seed, *shapes, dtype=torch.bfloat16):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(s, generator=g, device=card).to(dtype) for s in shapes]


def _listed(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _close(got, want, tol):
    for a, b in zip(_listed(got), _listed(want)):
        assert (a.float() - b.float()).abs().max().item() <= tol(b), (a.float() - b.float()).abs().max().item()


def _rel(x):
    return REL * x.float().abs().max().item()


def _share(dtype):
    """The tolerance of a dtype, a share of the largest output."""
    return REL if dtype == torch.bfloat16 else FP32_REL


def _same_bits(run, got):
    assert all(torch.equal(a, b) for a, b in zip(_listed(run()), _listed(got)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("b,tq,tk,kv_len", [(2, 300, 300, 290), (3, 48, 1500, None), (1, 65, 200, 1)])
def test_k3_and_k6_on_card(card, dh, b, tq, tk, kv_len, dtype):
    """K3 with and without lse (hpb 4 at dh 32, 1 at dh 128) and K6: both
    tile plans (tq <= 64 and above), a ragged key tail, a single valid key;
    fp32 launches count under the `_f32` names."""
    d, n_head = 512, 512 // dh
    q, k, v, g = _rnd(card, dh + tq, (b, tq, d), (b, tk, d), (b, tk, d), (b, tq, d), dtype=dtype)
    kw = dict(n_head=n_head, kv_valid_len=kv_len, scale=dh**-0.5)
    rel = _share(dtype)
    want, want_lse = PF.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
    reset_launch_counts()
    got = PF.flash_attention_h2(q, k, v, return_lse=True, **kw)
    assert tuple(got[1].shape) == (d // 128, b, tq, 128 // dh)
    _close(got[0], want, lambda w: rel * w.float().abs().max().item())
    _close(got[1], want_lse, lambda w: 1e-4 if dtype == torch.bfloat16 else FP32_REL * w.abs().max().item())
    _same_bits(lambda: PF.flash_attention_h2(q, k, v, return_lse=True, **kw), got)
    _close(PF.flash_attention_h2(q, k, v, **kw), want, lambda w: rel * w.float().abs().max().item())
    delta = PF.h2_delta(g, want, n_head)
    grads = PF.flash_attention_h2_bwd(q, k, v, want_lse, delta, g, **kw)
    want_grads = PF.flash_attention_h2_bwd_plain(q, k, v, want_lse, delta, g, **kw)
    # of the largest gradient: with one valid key dq cancels to ~1e-7, where
    # bf16's rounding of dS (fp32's of dP - delta) is the whole of it
    scale = max(w.float().abs().max().item() for w in want_grads)
    _close(grads, want_grads, lambda w: rel * scale)
    _same_bits(lambda: PF.flash_attention_h2_bwd(q, k, v, want_lse, delta, g, **kw), grads)
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    assert {n: c for n, c in LAUNCHES.items() if c} == {f"flash_attention_h2_lse{sfx}": 2, f"flash_attention_h2{sfx}": 1,
                                                        f"flash_attention_h2_bwd{sfx}": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("bh,tq,tk,causal,q_offset,kv_len",
                         [(12, 130, 130, True, 0, None), (12, 48, 96, True, 48, None), (8, 37, 100, True, 7, 90),
                          (8, 50, 257, False, 0, 200), (4, 1536, 1536, False, 0, 1500)])
def test_k7_and_k8_on_card(card, dh, bh, tq, tk, causal, q_offset, kv_len, dtype):
    """K7 with and without lse and K8: causal, q_offset, a ragged valid
    length, odd tq, and the encoder's (B x H, 1536, dh) valid to 1500."""
    q, k, v, g = _rnd(card, dh + tq, (bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh), dtype=dtype)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_len, scale=dh**-0.5)
    rel = _share(dtype)
    want, want_lse = PF.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = PF.flash_attention(q, k, v, return_lse=True, **kw)
    _close(got[0], want, lambda w: rel * w.float().abs().max().item())
    _close(got[1], want_lse, lambda w: 1e-4 if dtype == torch.bfloat16 else FP32_REL * w.abs().max().item())
    _same_bits(lambda: PF.flash_attention(q, k, v, return_lse=True, **kw), got)
    _close(PF.flash_attention(q, k, v, **kw), want, lambda w: rel * w.float().abs().max().item())
    grads = PF.flash_attention_bwd(q, k, v, want, want_lse, g, **kw)
    want_grads = PF.flash_attention_bwd_plain(q, k, v, want, want_lse, g, **kw)
    scale = max(w.float().abs().max().item() for w in want_grads)
    _close(grads, want_grads, lambda w: rel * scale)
    _same_bits(lambda: PF.flash_attention_bwd(q, k, v, want, want_lse, g, **kw), grads)


# K5: the class widths in both dtypes; in bf16 the widths route A (8-120)
# and route B (136-768) serve, several heads each where d allows
K5_CASES = [(dh, n_head, dtype) for dh, n_head in [(32, 3), (128, 1), (32, 16)] for dtype in DTYPES] + [
    (dh, n_head, torch.bfloat16) for dh, n_head in [(8, 4), (24, 5), (40, 3), (80, 9), (96, 8), (120, 3), (136, 2),
                                                    (256, 3), (768, 1)]] + [
    (dh, n_head, torch.float32) for dh, n_head in [(136, 5), (200, 3), (256, 3), (384, 2), (768, 1)]]


@pytest.mark.cuda
@pytest.mark.parametrize("dh,n_head,dtype", K5_CASES)
def test_k5_on_card_takes_the_forward(card, dh, n_head, dtype):
    """K5 runs K3's forward at dh 32 and 128 over any number of heads (d
    need not be a multiple of 128), in bf16 and in fp32; in bf16 at the
    other widths up to 120 at their class over head maps, and at 136-768 on
    the wide forward (fp32: the fp32 wide forward). Both tile plans (tq 200
    and 40), keys valid short of tk and all valid."""
    d = dh * n_head
    reset_launch_counts()
    for b, tq, tk, kv_len in ((2, 200, 300, 270), (3, 40, 129, None)):
        q, k, v = _rnd(card, 3 + dh, (b, tq, d), (b, tk, d), (b, tk, d), dtype=dtype)
        kw = dict(n_head=n_head, kv_valid_len=kv_len, scale=dh**-0.5)
        got = PF.flash_attention_mh(q, k, v, **kw)
        _close(got, PF.flash_attention_mh_plain(q, k, v, **kw), lambda w: _share(dtype) * w.float().abs().max().item())
        _same_bits(lambda: PF.flash_attention_mh(q, k, v, **kw), got)
    assert LAUNCHES["flash_attention_mh" if dtype == torch.bfloat16 else "flash_attention_mh_f32"] == 4


@pytest.mark.cuda
def test_k5_plan_matches_the_c_dispatch(card):
    """`flash_mh_plan_bf16`, the plan the bf16 K5's C dispatch takes, and
    its fp16 twin's `flash_mh_plan_f16` equal `k5_plan` at every multiple of
    8 up to 768 and both tile plans; widths no route serves give an error
    there too."""
    import ctypes

    from asr_ttl_mtl_tpu_torch.ops import _cuda

    lib = _cuda.lib("flash_attention")
    out = (ctypes.c_int * 6)()
    routes = {"class": 0, "A": 1, "B": 2}
    for entry in (lib.flash_mh_plan_bf16, lib.flash_mh_plan_f16):
        for dh in range(8, 769, 8):
            for tq in (1, 64, 65, 1536):
                assert entry(dh, tq, ctypes.addressof(out)) == 0
                plan = PF.k5_plan(dh, tq)
                assert tuple(out) == (routes[plan.route], *plan[1:]), (dh, tq)
        for dh in (0, 4, 20, 132, 776):
            assert entry(dh, 64, ctypes.addressof(out)) != 0


@pytest.mark.cuda
def test_f32_wide_plan_matches_the_c_dispatch(card):
    """`flash_wide_plan_f32`, the plan the fp32 wide forward's C dispatch
    takes, equals `f32_wide_plan` at every multiple of 8 from 136 to 768;
    widths it does not serve give an error there too."""
    import ctypes

    from asr_ttl_mtl_tpu_torch.ops import _cuda

    lib = _cuda.lib("flash_attention")
    out = (ctypes.c_int * 4)()
    for dh in range(136, 769, 8):
        assert lib.flash_wide_plan_f32(dh, ctypes.addressof(out)) == 0
        assert tuple(out) == tuple(PF.f32_wide_plan(dh)), dh
    for dh in (0, 64, 128, 132, 776):
        assert lib.flash_wide_plan_f32(dh, ctypes.addressof(out)) != 0


@pytest.mark.cuda
def test_k8_wide_plans_match_the_c_dispatch(card):
    """`flash_wide_bwd_plan_bf16` and `flash_wide_bwd_plan_f32`, the plans
    K8's wide backwards take in C, equal `k8_wide_plan` and
    `f32_k8_wide_plan` at every multiple of 8 from 136 to 768; widths they
    do not serve give an error there too."""
    import ctypes

    from asr_ttl_mtl_tpu_torch.ops import _cuda

    lib = _cuda.lib("flash_attention")
    bf16, f32 = (ctypes.c_int * 7)(), (ctypes.c_int * 4)()
    for dh in range(136, 769, 8):
        assert lib.flash_wide_bwd_plan_bf16(dh, ctypes.addressof(bf16)) == 0
        assert tuple(bf16) == tuple(PF.k8_wide_plan(dh)), dh
        assert lib.flash_wide_bwd_plan_f32(dh, ctypes.addressof(f32)) == 0
        assert tuple(f32) == tuple(PF.f32_k8_wide_plan(dh)), dh
    for dh in (0, 64, 128, 132, 776):
        assert lib.flash_wide_bwd_plan_bf16(dh, ctypes.addressof(bf16)) != 0
        assert lib.flash_wide_bwd_plan_f32(dh, ctypes.addressof(f32)) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("b,group,tk,valid", [(8, 1, 1500, None), (8, 5, 1500, None), (1, 5, 1500, None),
                                              (4, 16, 448, 37), (8, 1, 128, 0), (3, 20, 1500, 1000)])
def test_k2_on_card(card, dh, b, group, tk, valid, dtype):
    """K2 over bf16 caches (2 bf16 steps of the largest output) and over
    fp32 caches (FP32_REL of it): cross and self, clusters of 1-8 CTAs,
    groups 1 to 20 in one launch."""
    d, n_head = 512, 512 // dh
    q, ck, cv = _rnd(card, tk + group, (b * group, 1, d), (2, b, tk, d), (2, b, tk, d), dtype=dtype)
    kw = dict(scale=dh**-0.5, valid_upto=valid, group=group)
    share = 2.0**-7 if dtype == torch.bfloat16 else FP32_REL
    reset_launch_counts()
    got = PD.decode_attention(q, ck, cv, 1, n_head, **kw)
    assert LAUNCHES["decode_attention" if dtype == torch.bfloat16 else "decode_attention_f32"] == 1
    _close(got, PD.decode_attention_plain(q, ck, cv, 1, n_head, **kw), lambda w: share * w.float().abs().max())
    _same_bits(lambda: PD.decode_attention(q, ck, cv, 1, n_head, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("b,group,tk,valid", [(8, 1, 1536, 1499), (8, 5, 1536, 1499), (1, 5, 1536, 1499),
                                              (2, 20, 1536, 1000), (4, 1, 512, 37), (4, 5, 128, 70)])
def test_k1_on_card(card, dh, b, group, tk, valid, dtype):
    """K1 over int8 caches: the cluster split (batch 1: tk_blk 512, 3
    CTAs), two row chunks (group 20), a self cache; within the plain
    version's flip bound, one bf16 rounding and fp32 noise, as phase 3
    (fp32 q: the flip bound and FP32_REL of the largest output, as phase
    20)."""
    d, n_head = 512, 512 // dh
    q, ck, cv = _rnd(card, tk + group + 1, (b * group, 1, d), (2, b, tk, d), (2, b, tk, d), dtype=dtype)
    (ki, ks), (vi, vs) = PD.quantize_kv_rows(ck.float()), PD.quantize_kv_rows(cv.float())
    kw = dict(scale=dh**-0.5, valid_upto=valid, group=group)
    want, flip = PD.decode_attention_i8_plain(q, ki, ks, vi, vs, 1, n_head, return_flip_bound=True, **kw)
    reset_launch_counts()
    got = PD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, **kw)
    assert LAUNCHES["decode_attention_i8" if dtype == torch.bfloat16 else "decode_attention_i8_f32"] == 1
    ref = want.float().abs()
    if dtype == torch.bfloat16:
        tol = (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
    else:
        tol = flip + FP32_REL * ref.max()
    assert ((got.float() - want.float()).abs() <= tol).all()
    _same_bits(lambda: PD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("h2_dh,dtype", [(80, torch.bfloat16), (96, torch.bfloat16), (80, torch.float32),
                                         (96, torch.float32)])
def test_other_widths_raise_on_card(card, h2_dh, dtype):
    """No fallback: K3 and K6 refuse 80 and 96 (they serve 32, 64 and 128,
    as the JAX package's h2 kernels); K1, K2, K7 and K8 refuse 776 and 1024
    (they serve 1-768), and the fp32 K5 20 and 776 (multiples of 8 up to
    768), each naming the range it serves; nothing launches."""
    n_head = 1280 // h2_dh if h2_dh == 80 else 768 // h2_dh
    d = h2_dh * n_head
    q, = _rnd(card, 0, (2, 64, d), dtype=dtype)
    res = torch.zeros((d // 128, 2, 64, 1), device=card)
    reset_launch_counts()
    for call in (lambda: PF.flash_attention_h2(q, q, q, n_head=n_head),
                 lambda: PF.flash_attention_h2_bwd(q, q, q, res, res, q, n_head=n_head)):
        with pytest.raises(ValueError, match="head width of 32, 64, 128"):
            call()
    for dh in (136, 20, 256, 1024, 776):
        qs, = _rnd(card, 0, (4, 64, dh), dtype=dtype)
        lse = torch.zeros((4, 64, 1), device=card)
        qd, ck = _rnd(card, 0, (2, 1, 2 * dh), (1, 2, 128, 2 * dh), dtype=dtype)
        ki, ks = PD.quantize_kv_rows(ck.float())
        qn, = _rnd(card, 0, (2, 64, 2 * dh), dtype=dtype)
        calls = []  # (the range the refusal names, the call)
        if dh in (1024, 776):
            calls += [("from 1 to 768", lambda: PD.decode_attention(qd, ck, ck, 0, 2, scale=1.0)),
                      ("from 1 to 768", lambda: PD.decode_attention_i8(qd, ki, ks, ki, ks, 0, 2, scale=1.0)),
                      ("from 1 to 768", lambda: PF.flash_attention(qs, qs, qs, causal=True)),
                      ("from 1 to 768", lambda: PF.flash_attention_bwd(qs, qs, qs, qs, lse, qs, causal=True))]
        if dh in (20, 776) and dtype == torch.float32:
            calls.append(("multiple of 8 from 8 to 768", lambda: PF.flash_attention_mh(qn, qn, qn, n_head=2)))
        for served, call in calls:
            with pytest.raises(ValueError, match=served):
                call()
    assert sum(LAUNCHES.values()) == 0


# ------------------------------------ every multiple of 8 up to 128 ------

ANY_WIDTHS = [8, 40, 80, 96, 120]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", ANY_WIDTHS)
def test_k7_and_k8_at_any_width_on_card(card, dh, dtype):
    """K7 with and without lse and K8 at a width below its class (columns
    past dh zeros in the class's tiles): causal, q_offset 48, and
    non-causal with keys valid short of tk, over both tile plans."""
    rel = _share(dtype)
    for bh, tq, tk, causal, q_offset, kv_len in ((12, 48, 48, True, 0, None), (12, 48, 96, True, 48, None),
                                                 (8, 130, 300, False, 0, 270)):
        q, k, v, g = _rnd(card, dh + tq + tk, (bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh), dtype=dtype)
        kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_len, scale=dh**-0.5)
        want, want_lse = PF.flash_attention_plain(q, k, v, return_lse=True, **kw)
        reset_launch_counts()
        got = PF.flash_attention(q, k, v, return_lse=True, **kw)
        _close(got[0], want, lambda w: rel * w.float().abs().max().item())
        _close(got[1], want_lse, lambda w: 1e-4 if dtype == torch.bfloat16 else FP32_REL * w.abs().max().item())
        _same_bits(lambda: PF.flash_attention(q, k, v, return_lse=True, **kw), got)
        _close(PF.flash_attention(q, k, v, **kw), want, lambda w: rel * w.float().abs().max().item())
        grads = PF.flash_attention_bwd(q, k, v, want, want_lse, g, **kw)
        want_grads = PF.flash_attention_bwd_plain(q, k, v, want, want_lse, g, **kw)
        scale = max(w.float().abs().max().item() for w in want_grads)
        _close(grads, want_grads, lambda w: rel * scale)
        _same_bits(lambda: PF.flash_attention_bwd(q, k, v, want, want_lse, g, **kw), grads)
        sfx = "" if dtype == torch.bfloat16 else "_f32"
        assert {n: c for n, c in LAUNCHES.items() if c} == {f"flash_attention_lse{sfx}": 2,
                                                            f"flash_attention{sfx}": 1,
                                                            f"flash_attention_bwd{sfx}": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dh", ANY_WIDTHS)
def test_k5_fp32_at_any_width_on_card(card, dh):
    """The fp32 K5 over the natural layout at 3 heads of dh (head h at
    column h dh), keys valid to 270 of 300."""
    d = 3 * dh
    q, k, v = _rnd(card, dh, (2, 200, d), (2, 300, d), (2, 300, d), dtype=torch.float32)
    kw = dict(n_head=3, kv_valid_len=270, scale=dh**-0.5)
    reset_launch_counts()
    got = PF.flash_attention_mh(q, k, v, **kw)
    _close(got, PF.flash_attention_mh_plain(q, k, v, **kw), lambda w: FP32_REL * w.float().abs().max().item())
    _same_bits(lambda: PF.flash_attention_mh(q, k, v, **kw), got)
    assert LAUNCHES["flash_attention_mh_f32"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", ANY_WIDTHS)
def test_k2_and_k1_at_any_width_on_card(card, dh, dtype):
    """K2 and K1 at 5 heads of dh (an odd head count: at dh 40 and 120 K1's
    odd heads start 8 bytes off a 16-byte boundary) over a cross cache and
    a self cache, groups 1 and 5; K2 at phase 3's bf16 tolerance or
    FP32_REL, K1 within the flip bound."""
    n_head = 5
    d = n_head * dh
    for b, group, tk, valid in ((8, 1, 1536, 1499), (4, 5, 1536, 1499), (8, 5, 448, 37)):
        q, ck, cv = _rnd(card, tk + group + dh, (b * group, 1, d), (2, b, tk, d), (2, b, tk, d), dtype=dtype)
        kw = dict(scale=dh**-0.5, valid_upto=valid, group=group)
        share = 2.0**-7 if dtype == torch.bfloat16 else FP32_REL
        reset_launch_counts()
        got = PD.decode_attention(q, ck, cv, 1, n_head, **kw)
        _close(got, PD.decode_attention_plain(q, ck, cv, 1, n_head, **kw), lambda w: share * w.float().abs().max())
        _same_bits(lambda: PD.decode_attention(q, ck, cv, 1, n_head, **kw), got)
        (ki, ks), (vi, vs) = PD.quantize_kv_rows(ck.float()), PD.quantize_kv_rows(cv.float())
        want, flip = PD.decode_attention_i8_plain(q, ki, ks, vi, vs, 1, n_head, return_flip_bound=True, **kw)
        got = PD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, **kw)
        ref = want.float().abs()
        if dtype == torch.bfloat16:
            tol = (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
        else:
            tol = flip + FP32_REL * ref.max()
        assert ((got.float() - want.float()).abs() <= tol).all()
        _same_bits(lambda: PD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, **kw), got)
        sfx = "" if dtype == torch.bfloat16 else "_f32"
        assert LAUNCHES[f"decode_attention{sfx}"] == 2 and LAUNCHES[f"decode_attention_i8{sfx}"] == 2


# ---------------------------------- above 128 for serving (136-768) ------

WIDE_WIDTHS = [136, 200, 256, 384, 768]
DECODE_WIDE_WIDTHS = [136, 200, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", WIDE_WIDTHS)
def test_k7_wide_on_card(card, dh, dtype):
    """K7 with and without lse on the wide forwards (bf16: route B's kernel;
    fp32: the fp32 wide forward): causal at q_offset 0 and over 96 keys at
    q_offset 48, causal over 160 queries (two warpgroups in bf16 up to
    256), non-causal with keys valid short of tk."""
    rel = _share(dtype)
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    for bh, tq, tk, causal, q_offset, kv_len in ((12, 48, 48, True, 0, None), (12, 48, 96, True, 48, None),
                                                 (4, 160, 160, True, 0, None), (8, 130, 300, False, 0, 270)):
        q, k, v = _rnd(card, dh + tq + tk, (bh, tq, dh), (bh, tk, dh), (bh, tk, dh), dtype=dtype)
        kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_len, scale=dh**-0.5)
        want, want_lse = PF.flash_attention_plain(q, k, v, return_lse=True, **kw)
        reset_launch_counts()
        got = PF.flash_attention(q, k, v, return_lse=True, **kw)
        _close(got[0], want, lambda w: rel * w.float().abs().max().item())
        _close(got[1], want_lse, lambda w: 1e-4 if dtype == torch.bfloat16 else FP32_REL * w.abs().max().item())
        _same_bits(lambda: PF.flash_attention(q, k, v, return_lse=True, **kw), got)
        out = PF.flash_attention(q, k, v, **kw)
        _close(out, want, lambda w: rel * w.float().abs().max().item())
        _same_bits(lambda: PF.flash_attention(q, k, v, **kw), out)
        assert {n: c for n, c in LAUNCHES.items() if c} == {f"flash_attention_lse{sfx}": 2,
                                                            f"flash_attention{sfx}": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", WIDE_WIDTHS)
def test_k8_wide_on_card(card, dh, dtype):
    """K8 on the wide backwards (bf16: the TMA + wgmma dq and dk/dv kernels,
    a CTA a 128-column slab; fp32: the 3xTF32 pair): causal at q_offset 0
    and over 96 keys at q_offset 48, causal over 160 queries, non-causal
    with keys valid short of tk, and 70 keys under 200 queries; dq, dk and
    dv within the dtype's share of the plain version's largest output,
    bitwise on a second launch, one launch a call."""
    rel = _share(dtype)
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    for bh, tq, tk, causal, q_offset, kv_len in ((12, 48, 48, True, 0, None), (12, 48, 96, True, 48, None),
                                                 (4, 160, 160, True, 0, None), (8, 130, 300, False, 0, 270),
                                                 (3, 200, 70, False, 0, None)):
        q, k, v, g = _rnd(card, dh + tq + tk, (bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh), dtype=dtype)
        kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_len, scale=dh**-0.5)
        out, lse = PF.flash_attention_plain(q, k, v, return_lse=True, **kw)
        reset_launch_counts()
        got = PF.flash_attention_bwd(q, k, v, out, lse, g, **kw)
        for a, w in zip(got, PF.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)):
            _close(a, w, lambda x: rel * x.float().abs().max().item())
        _same_bits(lambda: PF.flash_attention_bwd(q, k, v, out, lse, g, **kw), got)
        assert {n: c for n, c in LAUNCHES.items() if c} == {f"flash_attention_bwd{sfx}": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", DECODE_WIDE_WIDTHS)
def test_k2_and_k1_at_the_class_of_256_on_card(card, dh, dtype):
    """K2 and K1 at 5 heads of dh in the class of 256 (at 136 and 200 K1's
    odd heads start 8 bytes off a 16-byte boundary) over cross caches of
    1536 keys valid to 1499 at groups 1, 5 and 16 (one cache row: int8 key
    blocks of 512) and a self cache; K2 at phase 3's bf16 tolerance or
    FP32_REL, K1 within the flip bound."""
    n_head = 5
    d = n_head * dh
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    for b, group, tk, valid in ((2, 1, 1536, 1499), (2, 5, 1536, 1499), (2, 16, 1536, 1499), (1, 1, 1536, 1499),
                                (8, 5, 448, 37)):
        q, ck, cv = _rnd(card, tk + group + dh, (b * group, 1, d), (2, b, tk, d), (2, b, tk, d), dtype=dtype)
        kw = dict(scale=dh**-0.5, valid_upto=valid, group=group)
        share = 2.0**-7 if dtype == torch.bfloat16 else FP32_REL
        reset_launch_counts()
        got = PD.decode_attention(q, ck, cv, 1, n_head, **kw)
        _close(got, PD.decode_attention_plain(q, ck, cv, 1, n_head, **kw), lambda w: share * w.float().abs().max())
        _same_bits(lambda: PD.decode_attention(q, ck, cv, 1, n_head, **kw), got)
        (ki, ks), (vi, vs) = PD.quantize_kv_rows(ck.float()), PD.quantize_kv_rows(cv.float())
        want, flip = PD.decode_attention_i8_plain(q, ki, ks, vi, vs, 1, n_head, return_flip_bound=True, **kw)
        got = PD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, **kw)
        ref = want.float().abs()
        if dtype == torch.bfloat16:
            tol = (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
        else:
            tol = flip + FP32_REL * ref.max()
        assert ((got.float() - want.float()).abs() <= tol).all()
        _same_bits(lambda: PD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, **kw), got)
        assert LAUNCHES[f"decode_attention{sfx}"] == 2 and LAUNCHES[f"decode_attention_i8{sfx}"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_wide_width_on_card(card, dtype):
    """Every multiple of 8 the wide kernels serve (136-768): K7 with lse and
    K8, causal at q_offset 30 over 70 keys, and the fp32 K5 (768 // dh heads,
    keys valid to 60); every multiple of 8 from 136 to 256 in K2 and K1 at
    5 heads over a 1536-key cross cache valid to 1499, group 5. Each
    against its plain version at the dtype's tolerance."""
    rel = _share(dtype)
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    reset_launch_counts()
    for dh in range(136, 769, 8):
        q, k, v = _rnd(card, dh, (2, 40, dh), (2, 70, dh), (2, 70, dh), dtype=dtype)
        kw = dict(causal=True, q_offset=30, scale=dh**-0.5)
        want, want_lse = PF.flash_attention_plain(q, k, v, return_lse=True, **kw)
        got = PF.flash_attention(q, k, v, return_lse=True, **kw)
        _close(got[0], want, lambda w: rel * w.float().abs().max().item())
        _close(got[1], want_lse, lambda w: 1e-4 if dtype == torch.bfloat16 else FP32_REL * w.abs().max().item())
        g, = _rnd(card, dh + 2, (2, 40, dh), dtype=dtype)
        for a, w in zip(PF.flash_attention_bwd(q, k, v, want, want_lse, g, **kw),
                        PF.flash_attention_bwd_plain(q, k, v, want, want_lse, g, **kw)):
            _close(a, w, lambda x: rel * x.float().abs().max().item())
        if dtype == torch.float32:
            n_head = max(1, 768 // dh)
            q, k, v = _rnd(card, dh + 1, (2, 40, n_head * dh), (2, 70, n_head * dh), (2, 70, n_head * dh),
                           dtype=dtype)
            kw = dict(n_head=n_head, kv_valid_len=60, scale=dh**-0.5)
            _close(PF.flash_attention_mh(q, k, v, **kw), PF.flash_attention_mh_plain(q, k, v, **kw),
                   lambda w: FP32_REL * w.float().abs().max().item())
    for dh in range(136, 257, 8):
        d = 5 * dh
        q, ck, cv = _rnd(card, dh + 2, (2 * 5, 1, d), (2, 2, 1536, d), (2, 2, 1536, d), dtype=dtype)
        kw = dict(scale=dh**-0.5, valid_upto=1499, group=5)
        share = 2.0**-7 if dtype == torch.bfloat16 else FP32_REL
        _close(PD.decode_attention(q, ck, cv, 1, 5, **kw), PD.decode_attention_plain(q, ck, cv, 1, 5, **kw),
               lambda w: share * w.float().abs().max())
        (ki, ks), (vi, vs) = PD.quantize_kv_rows(ck.float()), PD.quantize_kv_rows(cv.float())
        want, flip = PD.decode_attention_i8_plain(q, ki, ks, vi, vs, 1, 5, return_flip_bound=True, **kw)
        got = PD.decode_attention_i8(q, ki, ks, vi, vs, 1, 5, **kw)
        ref = want.float().abs()
        if dtype == torch.bfloat16:
            tol = (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
        else:
            tol = flip + FP32_REL * ref.max()
        assert ((got.float() - want.float()).abs() <= tol).all(), dh
    n_wide, n_decode = len(range(136, 769, 8)), len(range(136, 257, 8))
    assert LAUNCHES[f"flash_attention_lse{sfx}"] == LAUNCHES[f"flash_attention_bwd{sfx}"] == n_wide
    assert LAUNCHES[f"decode_attention{sfx}"] == LAUNCHES[f"decode_attention_i8{sfx}"] == n_decode
    assert LAUNCHES["flash_attention_mh_f32"] == (n_wide if dtype == torch.float32 else 0)


# ------------------------------- every head width up to 768 (1-768) ------

DECODE_FULL_WIDTHS = [264, 384, 512, 640, 768]  # the classes of 512 and 768
OFF_WIDTHS = [4, 20, 75, 100, 300]  # off a multiple of 8: rows copied in 8, 8, 1-2, 8 and 8 byte pieces (bf16)
FLASH_OFF_WIDTHS = [3, 20, 75, 100, 300, 700]


def _decode_checked(card, dh, n_head, cases, dtype):
    """K2 and K1 at n_head heads of dh over each (rows b, group, tk,
    valid_upto) case: K2 within 2^-7 (bf16) or FP32_REL of the plain
    version's largest output, K1 within its flip bound, each bitwise on a
    second launch and one launch a call."""
    d = n_head * dh
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    share = 2.0**-7 if dtype == torch.bfloat16 else FP32_REL
    for b, group, tk, valid in cases:
        q, ck, cv = _rnd(card, tk + group + dh, (b * group, 1, d), (2, b, tk, d), (2, b, tk, d), dtype=dtype)
        kw = dict(scale=dh**-0.5, valid_upto=valid, group=group)
        reset_launch_counts()
        got = PD.decode_attention(q, ck, cv, 1, n_head, **kw)
        _close(got, PD.decode_attention_plain(q, ck, cv, 1, n_head, **kw), lambda w: share * w.float().abs().max())
        _same_bits(lambda: PD.decode_attention(q, ck, cv, 1, n_head, **kw), got)
        (ki, ks), (vi, vs) = PD.quantize_kv_rows(ck.float()), PD.quantize_kv_rows(cv.float())
        want, flip = PD.decode_attention_i8_plain(q, ki, ks, vi, vs, 1, n_head, return_flip_bound=True, **kw)
        got = PD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, **kw)
        ref = want.float().abs()
        if dtype == torch.bfloat16:
            tol = (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
        else:
            tol = flip + FP32_REL * ref.max()
        assert ((got.float() - want.float()).abs() <= tol).all(), (dh, b, group)
        _same_bits(lambda: PD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, **kw), got)
        assert LAUNCHES[f"decode_attention{sfx}"] == 2 and LAUNCHES[f"decode_attention_i8{sfx}"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", DECODE_FULL_WIDTHS)
def test_k2_and_k1_from_264_to_768_on_card(card, dh, dtype):
    """K2 and K1 in the classes of 512 and 768 at 2 heads of dh over cross
    caches of 1536 keys valid to 1499 at groups 1, 5, 16 and 20 (above 16 a
    K2 CTA takes 16 rows), one cache row at group 1 (int8 key blocks of up
    to 512) and a 448-row self cache valid to 37."""
    _decode_checked(card, dh, 2, ((2, 1, 1536, 1499), (2, 5, 1536, 1499), (2, 16, 1536, 1499),
                                  (2, 20, 1536, 1499), (1, 1, 1536, 1499), (4, 5, 448, 37)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", OFF_WIDTHS)
def test_k2_and_k1_off_multiples_of_8_on_card(card, dh, dtype):
    """K2 and K1 at 5 heads of a width off a multiple of 8 (head h at column
    h dh: odd heads of 75 start on an odd byte of an int8 row and an even
    one of a bf16 row), over cross caches at groups 1, 5 and 16 and a
    self cache."""
    _decode_checked(card, dh, 5, ((2, 1, 1536, 1499), (2, 5, 1536, 1499), (2, 16, 1536, 1499),
                                  (8, 5, 448, 37)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", FLASH_OFF_WIDTHS)
def test_k7_and_k8_off_multiples_of_8_on_card(card, dh, dtype):
    """K7 with and without lse and K8 at a width off a multiple of 8, laid
    out at kernel_width(dh) by the wrappers: causal, q_offset 48 and
    non-causal with keys valid short of tk; outputs of width dh within the
    dtype's share of the plain version's largest, bitwise on a second
    launch, one launch a call."""
    rel = _share(dtype)
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    for bh, tq, tk, causal, q_offset, kv_len in ((12, 48, 48, True, 0, None), (12, 48, 96, True, 48, None),
                                                 (8, 130, 300, False, 0, 270)):
        q, k, v, g = _rnd(card, dh + tq + tk, (bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh), dtype=dtype)
        kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_len, scale=dh**-0.5)
        want, want_lse = PF.flash_attention_plain(q, k, v, return_lse=True, **kw)
        reset_launch_counts()
        got = PF.flash_attention(q, k, v, return_lse=True, **kw)
        assert tuple(got[0].shape) == (bh, tq, dh)
        _close(got[0], want, lambda w: rel * w.float().abs().max().item())
        _close(got[1], want_lse, lambda w: 1e-4 if dtype == torch.bfloat16 else FP32_REL * w.abs().max().item())
        _same_bits(lambda: PF.flash_attention(q, k, v, return_lse=True, **kw), got)
        _close(PF.flash_attention(q, k, v, **kw), want, lambda w: rel * w.float().abs().max().item())
        grads = PF.flash_attention_bwd(q, k, v, want, want_lse, g, **kw)
        want_grads = PF.flash_attention_bwd_plain(q, k, v, want, want_lse, g, **kw)
        scale = max(w.float().abs().max().item() for w in want_grads)
        _close(grads, want_grads, lambda w: rel * scale)
        _same_bits(lambda: PF.flash_attention_bwd(q, k, v, want, want_lse, g, **kw), grads)
        assert {n: c for n, c in LAUNCHES.items() if c} == {f"flash_attention_lse{sfx}": 2,
                                                            f"flash_attention{sfx}": 1,
                                                            f"flash_attention_bwd{sfx}": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_decode_width_from_264_on_card(card, dtype):
    """Every multiple of 8 from 264 to 768 in K2 and K1 at 2 heads over a
    1536-key cross cache valid to 1499, group 5, each against its plain
    version at the dtype's tolerance."""
    reset_launch_counts()
    for dh in range(264, 769, 8):
        _decode_checked(card, dh, 2, ((2, 5, 1536, 1499),), dtype)


@pytest.mark.cuda
def test_decode_plans_match_the_c_dispatch(card):
    """`decode_smem_bytes` and `decode_i8_smem_bytes`, the shared memory the
    C launchers give K2's and K1's CTAs, equal `k2_smem_bytes` and
    `k1_smem_bytes` at every width from 1 to 768 (at the width's class),
    for both cache dtypes, groups 1, 5, 9, 16 and 40 and chunks of 1 to
    1500 keys, rows 1-16 and key blocks of 128-1024; a width past 768 gives
    -1."""
    from asr_ttl_mtl_tpu_torch.ops import _cuda, decode_class

    lib = _cuda.lib("decode_attention")
    for dh in range(1, 769):
        cls = decode_class(dh)
        for itemsize in (2, 4):
            for group in (1, 5, 9, 16, 40):
                for chunk in (1, 63, 188, 375, 1500):
                    assert lib.decode_smem_bytes(itemsize, dh, group, chunk) == \
                        PD.k2_smem_bytes(group, chunk, itemsize, cls), (dh, itemsize, group, chunk)
        for rows in (1, 5, 16):
            for tk_blk in (128, 256, 512, 1024):
                assert lib.decode_i8_smem_bytes(dh, rows, tk_blk) == PD.k1_smem_bytes(rows, tk_blk, cls)
    assert lib.decode_smem_bytes(2, 776, 1, 128) == lib.decode_i8_smem_bytes(0, 1, 128) == -1
