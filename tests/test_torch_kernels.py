"""Plain versions of the port's kernels K1-K3 against the Pallas kernels
(interpret mode on CPU), plus the kernels (K1-K3, K5, K14) against their
plain versions on the card (marked `cuda`, skipped without one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.ops import decode_attention as JD
from asr_ttl_mtl_tpu.ops.flash_attention import flash_attention_h2 as jax_h2
from asr_ttl_mtl_tpu.ops.flash_attention import h2_eligible as jax_h2_eligible
from asr_ttl_mtl_tpu_torch.ops import decode_attention as PD
from asr_ttl_mtl_tpu_torch.models import whisper as PW
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF
from asr_ttl_mtl_tpu_torch.ops import int8_mlp as PM

from torch_port_helpers import cuda_device  # noqa: F401

ATOL = 1e-5  # fp32 both sides; only the order of the sums differs


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- K3 ------


@pytest.mark.parametrize(
    "b,tq,tk,n_head,kv_valid_len",
    [(2, 128, 128, 2, 96), (1, 48, 200, 2, 150), (2, 128, 128, 4, None)],
)
def test_k3_plain_matches_pallas(b, tq, tk, n_head, kv_valid_len):
    d = 128 if n_head == 2 else 256
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, t, d).astype(np.float32) for t in (tq, tk, tk))
    want = jax_h2(q, k, v, n_head=n_head, kv_valid_len=kv_valid_len, scale=(d // n_head) ** -0.5,
                  return_lse=False, interpret=True)
    got = PF.flash_attention_h2(_t(q), _t(k), _t(v), n_head=n_head, kv_valid_len=kv_valid_len,
                                scale=(d // n_head) ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_h2_eligible_same_rule():
    for args in [(1536, 1536, 512, 8), (15, 1536, 512, 8), (32, 5000, 512, 8), (64, 64, 384, 6),
                 (64, 64, 1280, 20), (64, 64, 96, 3)]:
        assert PF.h2_eligible(*args) == jax_h2_eligible(*args)


# ---------------------------------------------------------------- K2 ------


def _decode_inputs(b, group, n_layer, tk, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b * group, 1, d) * 0.5).astype(np.float32)
    ck = rng.randn(n_layer, b, tk, d).astype(np.float32)
    cv = rng.randn(n_layer, b, tk, d).astype(np.float32)
    return q, ck, cv


@pytest.mark.parametrize(
    "case,b,group,tk,valid",
    [("cross", 3, 1, 96, None), ("self", 2, 1, 128, 37), ("group", 2, 3, 96, None), ("self-group", 2, 2, 128, 0),
     ("group-9", 2, 9, 96, None)],
)
def test_k2_plain_matches_pallas(case, b, group, tk, valid):
    q, ck, cv = _decode_inputs(b, group, 2, tk, 128, seed=1)
    kw = dict(scale=64**-0.5, valid_upto=valid, group=group)
    want = JD.decode_attention(q, ck, cv, 1, 2, interpret=True, **kw)
    got = PD.decode_attention(_t(q), _t(ck), _t(cv), 1, 2, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------- K1 ------


def test_quantize_kv_rows_matches():
    x = np.random.RandomState(2).randn(2, 3, 100, 128).astype(np.float32)
    jq, js = JD.quantize_kv_rows(jnp.asarray(x))
    pq, ps = PD.quantize_kv_rows(_t(x))
    assert pq.shape == (2, 3, 128, 128) and pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_i8_blocks_same_rule():
    for b in (1, 2, 3, 8, 9, 16, 20, 32, 40):
        for tk in (128, 256, 384, 1536, 1500):
            for d in (128, 512, 1280):
                assert PD._i8_blocks(b, tk, d) == JD._i8_blocks(b, tk, d), (b, tk, d)
                assert PD.i8_supported(b, tk, d) == JD.i8_supported(b, tk, d)


@pytest.mark.parametrize(
    "b,group,tk,valid,tk_blk",
    [(2, 1, 1536, 1499, 512), (3, 1, 128, 40, 128), (16, 1, 256, None, 256), (2, 2, 384, 300, 128)],
)
def test_k1_plain_matches_pallas(b, group, tk, valid, tk_blk):
    """Geometries with different key blocks. Tolerance: exp and the sums may
    differ in their last bits, which can round a p*v_scale that lies at a
    rounding midpoint to the other int8 neighbour; the plain version bounds
    what such flips move per output, and fp32 noise adds ATOL."""
    assert PD._i8_blocks(b, tk, 128)[1] == tk_blk
    q, ck, cv = _decode_inputs(b, group, 2, tk, 128, seed=3)
    ki, ks = JD.quantize_kv_rows(jnp.asarray(ck))
    vi, vs = JD.quantize_kv_rows(jnp.asarray(cv))
    kw = dict(scale=64**-0.5, valid_upto=valid, group=group)
    want = JD.decode_attention_i8(q, ki, ks, vi, vs, 1, 2, interpret=True, **kw)
    got, flip = PD.decode_attention_i8_plain(_t(q), _t(ki), _t(ks), _t(vi), _t(vs), 1, 2,
                                             return_flip_bound=True, **kw)
    assert torch.equal(got, PD.decode_attention_i8(_t(q), _t(ki), _t(ks), _t(vi), _t(vs), 1, 2, **kw))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert np.all(diff <= ATOL + flip.numpy()), (diff - flip.numpy()).max()
    # and in the common case no p rounds differently at all
    assert np.mean(diff <= ATOL) > 0.99


def test_k1_flip_bound_separates_block_sizes():
    """The flip bound is tight enough to tell key blocks apart: the same
    four cache rows at b=4 (tk_blk 512) and as half of b=8 (tk_blk 256)
    differ by far more than it allows, though p rounds per block in both."""
    q, ck, cv = _decode_inputs(8, 1, 1, 1536, 512, seed=6)
    ki, ks = PD.quantize_kv_rows(_t(ck))
    vi, vs = PD.quantize_kv_rows(_t(cv))
    assert PD._i8_blocks(4, 1536, 512)[1] == 512 and PD._i8_blocks(8, 1536, 512)[1] == 256
    kw = dict(scale=0.125, valid_upto=1499)
    blk256 = PD.decode_attention_i8_plain(_t(q), ki, ks, vi, vs, 0, 8, **kw)[:4]
    blk512, flip = PD.decode_attention_i8_plain(_t(q)[:4], ki[:, :4].contiguous(), ks[:, :4].contiguous(),
                                                vi[:, :4].contiguous(), vs[:, :4].contiguous(), 0, 8,
                                                return_flip_bound=True, **kw)
    over = (blk256 - blk512).abs() > ATOL + flip
    assert over.float().mean().item() > 0.2


# ------------------------------------------------------- on the card ------


@pytest.mark.cuda
def test_k3_kernel_on_card(cuda_device):  # noqa: F811
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, 200, 512), generator=g, device=cuda_device).bfloat16() for _ in range(3))
    kw = dict(n_head=8, kv_valid_len=150, scale=0.125)
    want = PF.flash_attention_h2_plain(q, k, v, **kw).float()
    got = PF.flash_attention_h2(q, k, v, **kw).float()
    assert (got - want).abs().max().item() <= 2.0**-6 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_kernel_on_card(cuda_device, dtype):  # noqa: F811
    q, ck, cv = (_t(a).to(cuda_device, dtype) for a in _decode_inputs(4, 2, 2, 300, 512, seed=4))
    kw = dict(scale=0.125, valid_upto=250, group=2)
    want = PD.decode_attention_plain(q, ck, cv, 1, 8, **kw).float()
    got = PD.decode_attention(q, ck, cv, 1, 8, **kw).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("group", [9, 16])
def test_k2_kernel_on_card_above_group_8(cuda_device, group):  # noqa: F811
    """Groups above 8 go in launches of at most 8 rows per cache row."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    q, ck, cv = (_t(a).to(cuda_device, torch.bfloat16) for a in _decode_inputs(3, group, 2, 1500, 512, seed=6))
    kw = dict(scale=0.125, group=group)
    want = PD.decode_attention_plain(q, ck, cv, 1, 8, **kw).float()
    reset_launch_counts()
    got = PD.decode_attention(q, ck, cv, 1, 8, **kw).float()
    assert LAUNCHES["decode_attention"] == -(-group // PD.MAX_GROUP)
    assert (got - want).abs().max().item() <= 2.0**-7 * want.abs().max().item()


@pytest.mark.cuda
def test_best_of_9_on_card_gives_the_plain_path_tokens(cuda_device, monkeypatch):  # noqa: F811
    """decode(best_of=9) with bf16 caches: the cross-attention runs K2 at
    group 9 and samples the tokens the plain K2 gives on the same card."""
    from asr_ttl_mtl_tpu_torch.decoding import DecodingOptions, decode
    from asr_ttl_mtl_tpu_torch.models import from_random
    from asr_ttl_mtl_tpu_torch.models import whisper as PW
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    model = from_random("tiny", seed=0, device=cuda_device, dtype=torch.bfloat16)
    mel = torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(0)).to(cuda_device) * 0.3
    opts = DecodingOptions(language="en", temperature=0.6, best_of=9, sample_len=12)
    reset_launch_counts()
    got = decode(model, mel, opts)
    assert LAUNCHES["decode_attention"] > 0
    monkeypatch.setattr(PW, "decode_attention", PD.decode_attention_plain)
    want = decode(model, mel, opts)
    assert [r.tokens for r in got] == [r.tokens for r in want]


@pytest.mark.cuda
def test_k1_kernel_on_card(cuda_device):  # noqa: F811
    q, ck, cv = _decode_inputs(4, 2, 2, 1536, 512, seed=5)
    ki, ks = PD.quantize_kv_rows(_t(ck).to(cuda_device))
    vi, vs = PD.quantize_kv_rows(_t(cv).to(cuda_device))
    qd = _t(q).to(cuda_device, torch.bfloat16)
    kw = dict(scale=0.125, valid_upto=1499, group=2)
    want, flip = PD.decode_attention_i8_plain(qd, ki, ks, vi, vs, 1, 8, return_flip_bound=True, **kw)
    want = want.float()
    got = PD.decode_attention_i8(qd, ki, ks, vi, vs, 1, 8, **kw).float()
    # per output: what p rounding flips can move, one bf16 rounding, fp32 noise
    tol = (1 + 2.0**-7) * flip + 2.0**-7 * want.abs() + 1e-5 * want.abs().max()
    assert ((got - want).abs() <= tol).all()


@pytest.mark.cuda
def test_k14_kernel_on_card(cuda_device):  # noqa: F811
    """The kernel against its plain version at a small shape with a ragged
    last block: both quantize the same values, so the int8 intermediates
    agree but where tanhf's last bit moves a bf16 GELU rounding, and each
    output within one activation step per flipped second intermediate plus
    one bf16 rounding."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    g = torch.Generator(device=cuda_device).manual_seed(0)
    d, h, n = 256, 1024, 300
    x = torch.randn((n, d), generator=g, device=cuda_device).bfloat16()
    w1, w2 = (torch.randn(s, generator=g, device=cuda_device) * 0.05 for s in ((h, d), (d, h)))
    w1q, s1 = PW._quant_rowwise_sym(w1)
    w2q, s2 = PW._quant_rowwise_sym(w2)
    b1, b2 = torch.randn(h, device=cuda_device) * 0.1, torch.randn(d, device=cuda_device) * 0.1
    args = (x, w1q, s1.reshape(-1), b1, w2q, s2.reshape(-1), b2)
    want, pqx, pqg, psg = PM.int8_mlp_plain(*args, return_int8=True)
    reset_launch_counts()
    got, qx, qg, sg = PM.int8_mlp(*args, return_int8=True)
    assert LAUNCHES["int8_mlp"] == 1
    assert torch.equal(qx, pqx)
    flips = (qg.int() - pqg.int()).abs()
    assert flips.max().item() <= 1 and flips.float().mean().item() < 1e-3
    bound = (flips.float() @ w2q.float().abs().t()) * psg * s2.reshape(1, -1)
    tol = bound + 2.0**-7 * want.float().abs() + 1e-5
    assert ((got.float() - want.float()).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dh,n_head", [(64, 9), (8, 2), (80, 2), (768, 1)])
def test_k5_kernel_on_card(cuda_device, dh, n_head):  # noqa: F811
    """K5 at head width 64 (K3's device code, 9 heads: d % 128 != 0) and at
    other widths (its own kernel), unaligned Tq and a masked key tail;
    the tolerance of K3."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    g = torch.Generator(device=cuda_device).manual_seed(1)
    d = dh * n_head
    q, k, v = (torch.randn((2, t, d), generator=g, device=cuda_device).bfloat16() for t in (37, 150, 150))
    kw = dict(n_head=n_head, kv_valid_len=130, scale=dh**-0.5)
    want = PF.flash_attention_mh_plain(q, k, v, **kw).float()
    reset_launch_counts()
    got = PF.flash_attention_mh(q, k, v, **kw).float()
    assert LAUNCHES["flash_attention_mh"] == 1
    assert (got - want).abs().max().item() <= 2.0**-6 * want.abs().max().item()
