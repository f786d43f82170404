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
    [(2, 128, 128, 2, 96), (1, 48, 200, 2, 150), (2, 128, 128, 4, None), (2, 32, 300, 2, 290)],
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
     ("group-9", 2, 9, 96, None), ("group-16", 2, 16, 96, None), ("self-first-key", 2, 1, 128, 0),
     ("group-16-self", 1, 16, 128, 37)],
)
def test_k2_plain_matches_pallas(case, b, group, tk, valid):
    q, ck, cv = _decode_inputs(b, group, 2, tk, 128, seed=1)
    kw = dict(scale=64**-0.5, valid_upto=valid, group=group)
    want = JD.decode_attention(q, ck, cv, 1, 2, interpret=True, **kw)
    got = PD.decode_attention(_t(q), _t(ck), _t(cv), 1, 2, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("batch", [1, 32, 160])
@pytest.mark.parametrize("n_keys", [1, 38, 127, 128, 448, 1500])
@pytest.mark.parametrize("group", [1, 16])
def test_k2_plan_chunks_cover_the_valid_keys(batch, n_keys, group):
    """S is a cluster size the card takes, every CTA gets keys, the chunks
    cover [0, n_keys) in order, and short caches take one CTA."""
    split = PD.k2_plan(batch, 8, n_keys, group)
    assert split in PD.K2_SPLITS and split <= 8
    chunks = PD.k2_chunks(n_keys, split)
    assert len(chunks) == split
    assert chunks[0][0] == 0 and chunks[-1][1] == n_keys
    assert all(hi > lo for lo, hi in chunks)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    if n_keys < 2 * PD.K2_MIN_KEYS:
        assert split == 1
    if split > 1:
        assert n_keys // split >= PD.K2_MIN_KEYS
    assert PD.k2_smem_bytes(group, chunks[0][1], 2) <= 227 * 1024


def test_k2_plan_examples():
    """The rule's examples: one window of the CLI takes 8 CTAs a head; 32
    windows already fill the resident slots with 1; a 71-key self cache
    takes 1; 4 windows take 8 and 5 windows 4."""
    assert PD.k2_plan(1, 8, 1500) == 8
    assert PD.k2_plan(32, 8, 1500) == 1
    assert PD.k2_plan(32, 8, 71) == 1
    assert PD.k2_plan(1, 8, 1500, group=5) == 8
    assert PD.k2_plan(4, 8, 1500) == 8
    assert PD.k2_plan(5, 8, 1500) == 4
    assert PD.k2_plan(1, 8, 300) == 4


class _FakeK2Lib:
    """Records the C entry calls the K2 wrapper makes (no card here)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0

        return fn


@pytest.mark.parametrize("group,valid", [(1, None), (5, None), (9, 37), (16, None), (40, 0)])
def test_k2_one_launch_at_any_group(monkeypatch, group, valid):
    """The wrapper makes one kernel call for the whole group, with the
    cluster size k2_plan gives, and counts one launch."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES

    fake = _FakeK2Lib()
    monkeypatch.setattr(PD._cuda, "lib", lambda name: fake)
    monkeypatch.setattr(PD._cuda, "stream_handle", lambda device: 0)
    b, tk = 2, 1500
    q = torch.zeros((b * group, 1, 512), dtype=torch.bfloat16)
    ck = torch.zeros((2, b, tk, 512), dtype=torch.bfloat16)
    before = LAUNCHES["decode_attention"]
    PD._launch_k2(q, ck, ck, 1, 8, 0.125, valid, group)
    assert LAUNCHES["decode_attention"] == before + 1
    assert len(fake.calls) == 1
    name, args = fake.calls[0]
    assert name == "decode_attn_bf16"
    # q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split, scale, stream
    assert args[6:13] == (b, group, tk, 512, 8, -1 if valid is None else valid,
                          PD.k2_plan(b, 8, PD.k2_n_valid(tk, valid), group))


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


@pytest.mark.parametrize("batch", [1, 4, 32, 160])
@pytest.mark.parametrize("tk,valid", [(128, 70), (512, 37), (512, 255), (512, 256), (896, 800), (1536, 1499),
                                      (1536, None)])
@pytest.mark.parametrize("group", [1, 5, 16, 20])
def test_k1_plan_chunks_cover_the_valid_blocks(batch, tk, valid, group):
    """S is a cluster size the card takes and no larger than the valid
    blocks; every CTA gets whole tk_blk blocks; the chunks cover exactly
    [0, n_valid) in order; the grid stays within the resident CTAs unless
    S is 1."""
    tk_blk = PD._i8_blocks(batch, tk, 512)[1]
    n_valid = PD.k2_n_valid(tk, valid)
    n_blocks = PD.k1_n_blocks(tk, tk_blk, valid)
    assert n_blocks == -(-n_valid // tk_blk)
    split = PD.k1_plan(batch, 8, n_blocks, group)
    assert 1 <= split <= min(PD.K1_MAX_SPLIT, n_blocks)
    chunks = PD.k1_chunks(n_valid, tk_blk, split)
    assert len(chunks) == split
    assert chunks[0][0] == 0 and chunks[-1][1] == n_valid
    assert all(hi > lo for lo, hi in chunks)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(lo % tk_blk == 0 and (hi % tk_blk == 0 or hi == n_valid) for lo, hi in chunks)
    # the longest chunk is as short as the plan's S allows, and no S' < S gives it
    longest = max(-(-(hi - lo) // tk_blk) for lo, hi in chunks)
    assert longest == -(-n_blocks // split)
    assert split == 1 or -(-n_blocks // (split - 1)) > longest
    ctas = batch * 8 * -(-group // PD.K1_ROWS)
    assert split == 1 or ctas * split <= PD._K1_RESIDENT


def test_k1_plan_examples():
    """The rule's examples at base: 32 windows' cross store (6 valid blocks
    of 256) already fills the card with 1 CTA a (row, head), at group 5
    and 16 too; one window (3 blocks of 512) takes 3, at groups 5 and 16
    too; 8 windows could take 4 but take 3, which gives the same longest
    chunk (2 blocks); a one-block self cache takes 1."""
    assert PD.k1_plan(32, 8, 6) == 1
    assert PD.k1_plan(32, 8, 6, 5) == 1
    assert PD.k1_plan(32, 8, 6, 16) == 1
    assert PD.k1_plan(1, 8, 3) == 3
    assert PD.k1_plan(1, 8, 3, 5) == 3
    assert PD.k1_plan(1, 8, 3, 16) == 3
    assert PD.k1_plan(8, 8, 6) == 3
    assert PD.k1_plan(1, 8, 1) == 1


def _k1_split_plain(q, ki, ks, vi, vs, layer, n_head, *, scale, valid_upto, group, split):
    """Test-only emulation of the split K1 with the plain version's
    arithmetic: CTA r of the cluster walks the whole key blocks of
    `k1_chunks(...)[r]` in order from its own running max; the partials
    (m, l, acc) are then combined in rank order."""
    _, b, tk, d = ki.shape
    tk_blk = PD._i8_blocks(b, tk, d)[1]
    dh = d // n_head
    n_valid = PD.k2_n_valid(tk, valid_upto)
    qh = q.reshape(b, group, n_head, dh).float()
    sq = PD.int8_step(qh.abs().amax(dim=-1, keepdim=True), 1e-20)
    qi = torch.round(qh / sq).double()
    parts = []
    for lo, hi in PD.k1_chunks(n_valid, tk_blk, split):
        m = torch.full((b, group, n_head, 1), PD._NEG_INF)
        l = torch.zeros((b, group, n_head, 1))
        acc = torch.zeros((b, group, n_head, dh))
        for k0 in range(lo, hi, tk_blk):
            kb = ki[layer, :, k0:k0 + tk_blk].reshape(b, tk_blk, n_head, dh).double()
            vb = vi[layer, :, k0:k0 + tk_blk].reshape(b, tk_blk, n_head, dh).double()
            ksb = ks[layer, :, k0:k0 + tk_blk][:, None, None, :]
            vsb = vs[layer, :, k0:k0 + tk_blk][:, None, None, :]
            sc = torch.einsum("bghd,bkhd->bghk", qi, kb).float() * (sq * scale) * ksb
            masked = torch.arange(k0, k0 + tk_blk) >= n_valid
            sc = torch.where(masked, PD._NEG_INF, sc)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.where(masked, 0.0, torch.exp(sc - m_new))
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1, keepdim=True)
            m = m_new
            pv = p * vsb
            sp = PD.int8_step(pv.amax(dim=-1, keepdim=True), 1e-30)
            o32 = torch.einsum("bghk,bkhd->bghd", torch.round(pv / sp).double(), vb).float()
            acc = acc * corr + o32 * sp
        parts.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros_like(parts[0][1])
    acc_all = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - m_all)
        l_all = l_all + l * f
        acc_all = acc_all + acc * f
    return (acc_all / torch.where(l_all == 0.0, 1.0, l_all)).to(q.dtype).reshape(b * group, 1, d)


@pytest.mark.parametrize("split", [1, 2, 3, 6])
@pytest.mark.parametrize("b,group,tk,valid", [(2, 1, 896, 800), (3, 2, 896, None)])
def test_k1_split_keeps_the_contract(split, b, group, tk, valid):
    """The split K1 (each chunk of whole blocks from its own running max,
    partials combined in rank order) against the JAX kernel in interpret
    mode, within test_k1_plain_matches_pallas's tolerance: the running max
    cancels in p*v_scale / sp up to an fp32 rounding, which the flip bound
    covers. 7 blocks of 128 keys, so S = 6 gives chunks of 1 and 2 blocks."""
    assert PD._i8_blocks(b, tk, 128)[1] == 128
    q, ck, cv = _decode_inputs(b, group, 2, tk, 128, seed=8)
    ki, ks = JD.quantize_kv_rows(jnp.asarray(ck))
    vi, vs = JD.quantize_kv_rows(jnp.asarray(cv))
    kw = dict(scale=64**-0.5, valid_upto=valid, group=group)
    want = np.asarray(JD.decode_attention_i8(q, ki, ks, vi, vs, 1, 2, interpret=True, **kw))
    args = (_t(q), _t(ki), _t(ks), _t(vi), _t(vs), 1, 2)
    _, flip = PD.decode_attention_i8_plain(*args, return_flip_bound=True, **kw)
    got = _k1_split_plain(*args, split=split, **kw)
    if split == 1:  # one CTA is the sequential walk
        assert torch.equal(got, PD.decode_attention_i8_plain(*args, **kw))
    diff = np.abs(got.numpy() - want)
    assert np.all(diff <= ATOL + flip.numpy()), (diff - flip.numpy()).max()
    assert np.mean(diff <= ATOL) > 0.99


@pytest.mark.parametrize("group,valid", [(1, None), (5, 1499), (16, 37), (20, 0)])
def test_k1_one_launch_with_the_plan(monkeypatch, group, valid):
    """The wrapper makes one kernel call with tk_blk from _i8_blocks and the
    cluster size k1_plan gives, and counts one launch."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES

    fake = _FakeK2Lib()
    monkeypatch.setattr(PD._cuda, "lib", lambda name: fake)
    monkeypatch.setattr(PD._cuda, "stream_handle", lambda device: 0)
    b, tk = 2, 1536
    q = torch.zeros((b * group, 1, 512), dtype=torch.bfloat16)
    ck = torch.zeros((2, b, tk, 512), dtype=torch.int8)
    sc = torch.zeros((2, b, tk))
    tk_blk = PD._i8_blocks(b, tk, 512)[1]
    before = LAUNCHES["decode_attention_i8"]
    PD._launch_k1(q, ck, sc, ck, sc, 1, 8, 0.125, valid, group, tk_blk)
    assert LAUNCHES["decode_attention_i8"] == before + 1
    assert len(fake.calls) == 1
    name, args = fake.calls[0]
    assert name == "decode_attn_i8_bf16"
    # q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk, valid_upto, split, scale, stream
    assert args[6:16] == (1, 2, b, group, tk, 512, 8, tk_blk, -1 if valid is None else valid,
                          PD.k1_plan(b, 8, PD.k1_n_blocks(tk, tk_blk, valid), group))


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


# tolerance of a flash kernel's outputs against its plain version, a share
# of the largest output: bf16 rounds p and the outputs at other places; fp32
# sums in another order, its products in 3xTF32 (~2^-22 of each; one TF32
# pass would miss the bound by ~25x)
FLASH_REL = {torch.bfloat16: 2.0**-6, torch.float32: 2e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_kernel_on_card(cuda_device, dtype):  # noqa: F811
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, 200, 512), generator=g, device=cuda_device).to(dtype) for _ in range(3))
    kw = dict(n_head=8, kv_valid_len=150, scale=0.125)
    want = PF.flash_attention_h2_plain(q, k, v, **kw).float()
    got = PF.flash_attention_h2(q, k, v, **kw)
    assert got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= FLASH_REL[dtype] * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,tq,tk,kv_len", [(3, 32, 1500, None), (2, 48, 1536, 1500), (2, 300, 1536, 1500),
                                            (1, 64, 130, 129), (1, 65, 200, 1)])
def test_k3_kernel_on_card_with_lse(cuda_device, b, tq, tk, kv_len, dtype):  # noqa: F811
    """K3 with the logsumexp: one consumer warpgroup (tq <= 64) and two, a
    ragged last key tile, a single valid key; out within 2^-6 (bf16) or
    2e-5 (fp32) of the largest output, lse within 1e-4 (bf16, as K6 reads
    it) or 2e-5 of the largest; the same bits on a second launch."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    g = torch.Generator(device=cuda_device).manual_seed(2)
    q = torch.randn((b, tq, 512), generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, tk, 512), generator=g, device=cuda_device).to(dtype) for _ in range(2))
    kw = dict(n_head=8, kv_valid_len=kv_len, scale=0.125)
    want, want_lse = PF.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
    reset_launch_counts()
    got, got_lse = PF.flash_attention_h2(q, k, v, return_lse=True, **kw)
    assert LAUNCHES["flash_attention_h2_lse" if dtype == torch.bfloat16 else "flash_attention_h2_lse_f32"] == 1
    assert (got.float() - want.float()).abs().max().item() <= FLASH_REL[dtype] * want.float().abs().max().item()
    lse_tol = 1e-4 if dtype == torch.bfloat16 else 2e-5 * want_lse.abs().max().item()
    assert (got_lse - want_lse).abs().max().item() <= lse_tol
    assert torch.equal(PF.flash_attention_h2(q, k, v, **kw), got)
    assert all(torch.equal(a, c) for a, c in zip(PF.flash_attention_h2(q, k, v, return_lse=True, **kw), (got, got_lse)))


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
    """Groups above 8 take one launch, like any group."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    q, ck, cv = (_t(a).to(cuda_device, torch.bfloat16) for a in _decode_inputs(3, group, 2, 1500, 512, seed=6))
    kw = dict(scale=0.125, group=group)
    want = PD.decode_attention_plain(q, ck, cv, 1, 8, **kw).float()
    reset_launch_counts()
    got = PD.decode_attention(q, ck, cv, 1, 8, **kw).float()
    assert LAUNCHES["decode_attention"] == 1
    assert (got - want).abs().max().item() <= 2.0**-7 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,group,tk,valid", [(1, 1, 1500, None), (1, 5, 1500, None), (2, 1, 448, 0),
                                              (2, 3, 448, 37), (1, 1, 448, 300)])
def test_k2_kernel_on_card_split_edges(cuda_device, dtype, b, group, tk, valid):  # noqa: F811
    """Batch 1 (a cluster of 8 CTAs a head), valid_upto inside the first
    chunk (0 and 37: one CTA), and a split self cache."""
    q, ck, cv = (_t(a).to(cuda_device, dtype) for a in _decode_inputs(b, group, 2, tk, 512, seed=7))
    kw = dict(scale=0.125, valid_upto=valid, group=group)
    want = PD.decode_attention_plain(q, ck, cv, 1, 8, **kw).float()
    got = PD.decode_attention(q, ck, cv, 1, 8, **kw).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


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
@pytest.mark.parametrize("b,group,tk,valid", [(1, 1, 1536, 1499), (1, 5, 1536, 1499), (4, 16, 1536, 1499),
                                              (2, 20, 1536, 1000), (32, 1, 1536, 1499), (4, 1, 512, 37),
                                              (8, 1, 512, 255), (8, 1, 512, 256), (4, 1, 128, 70),
                                              (4, 5, 448, 300)])
def test_k1_kernel_on_card_split_edges(cuda_device, b, group, tk, valid):  # noqa: F811
    """K1's cluster split at its edges: batch 1 (tk_blk 512, S 3), groups 1,
    5, 16 and 20 (two row chunks), valid_upto inside the first block and at
    either side of a block boundary, and self caches of 128 and 448 (padded
    to 512) rows; within the flip bound of the plain version, and two
    launches give the same bits."""
    q, ck, cv = _decode_inputs(b, group, 2, tk, 512, seed=9)
    ki, ks = PD.quantize_kv_rows(_t(ck).to(cuda_device))
    vi, vs = PD.quantize_kv_rows(_t(cv).to(cuda_device))
    qd = _t(q).to(cuda_device, torch.bfloat16)
    kw = dict(scale=0.125, valid_upto=valid, group=group)
    want, flip = PD.decode_attention_i8_plain(qd, ki, ks, vi, vs, 1, 8, return_flip_bound=True, **kw)
    want = want.float()
    got = PD.decode_attention_i8(qd, ki, ks, vi, vs, 1, 8, **kw)
    assert torch.equal(got, PD.decode_attention_i8(qd, ki, ks, vi, vs, 1, 8, **kw))
    tol = (1 + 2.0**-7) * flip + 2.0**-7 * want.abs() + 1e-5 * want.abs().max()
    assert ((got.float() - want).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,h,tiny_row", [
    (300, 128, 512, None), (300, 256, 1024, None), (300, 384, 1536, None), (300, 512, 2048, None),
    (40, 512, 2048, None), (1000, 256, 1024, None), (100, 3072, 128, None), (300, 128, 2688, None),
    (300, 512, 2176, None), (300, 1024, 2048, None), (300, 1024, 128, None), (300, 512, 2048, 7),
    (100, 1280, 1280, None)],
    ids=["d128", "d256", "d384", "d512", "below-one-tile", "ragged", "mma-route", "odd-tiles-widest",
         "odd-tiles", "d1024", "one-hidden-tile", "tiny-row", "mma-route-d1280"])
def test_k14_kernel_on_card(cuda_device, n, d, h, tiny_row, dtype):  # noqa: F811
    """The kernel against its plain version at every (d, 4d) the gate admits
    up to base's, below one 64-row tile, with a ragged last tile, at odd
    counts of hidden tiles (the two halves own different counts), at d 1024
    (8 pieces of a row a lane), at one hidden tile (one half runs no first
    product), with a row below 2^-100 (the scaled branch of the division)
    and at shapes `k14_plan` gives to the mma.sync kernel (d 3072 and 1280),
    in bf16 and fp32 activations: both quantize the same values, so the
    first int8 intermediate is equal and the second agrees but where
    tanhf's last bit moves the GELU (bf16: its rounding; fp32: the value
    itself) across a rounding midpoint of the quantization. Each output is
    within one activation step per flipped second intermediate plus one
    rounding of its dtype (2^-7 bf16, 2e-6 fp32). A second launch gives the
    same bits."""
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    assert PM.int8_mlp_supported(n, d, h)
    assert PM.k14_plan(n, d, h, torch.empty((), dtype=dtype).element_size()).route == (
        "mma" if d > PM.K14_MAX_D else "wgmma")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda_device).to(dtype)
    if tiny_row is not None:
        x[tiny_row] = (x[tiny_row].float() * 2.0**-103).to(dtype)
    w1, w2 = (torch.randn(s, generator=g, device=cuda_device) * 0.05 for s in ((h, d), (d, h)))
    w1q, s1 = PW._quant_rowwise_sym(w1)
    w2q, s2 = PW._quant_rowwise_sym(w2)
    b1, b2 = torch.randn(h, device=cuda_device) * 0.1, torch.randn(d, device=cuda_device) * 0.1
    args = (x, w1q, s1.reshape(-1), b1, w2q, s2.reshape(-1), b2)
    want, pqx, pqg, psg = PM.int8_mlp_plain(*args, return_int8=True)
    reset_launch_counts()
    got = PM.int8_mlp(*args, return_int8=True)
    assert LAUNCHES["int8_mlp" if dtype == torch.bfloat16 else "int8_mlp_f32"] == 1 and sum(LAUNCHES.values()) == 1
    assert all(torch.equal(a, b) for a, b in zip(PM.int8_mlp(*args, return_int8=True), got))
    out, qx, qg, _ = got
    assert out.dtype == dtype
    assert torch.equal(qx, pqx)
    flips = (qg.int() - pqg.int()).abs()
    assert flips.max().item() <= 1 and flips.float().mean().item() < 1e-3
    if dtype == torch.float32 and flips.any():  # only next to a rounding midpoint of g / sg
        sx = PW.int8_step(x.float().abs().amax(-1, keepdim=True), 1e-30)
        f1 = torch._int_mm(pqx, w1q.t()).float() * (sx * s1.reshape(1, -1)) + b1
        ratio = F.gelu(f1, approximate="tanh") / psg
        assert ((ratio.abs().frac() - 0.5).abs()[flips > 0] <= 1e-4).all()
    rounding = 2.0**-7 if dtype == torch.bfloat16 else 2e-6
    bound = (flips.float() @ w2q.float().abs().t()) * psg * s2.reshape(1, -1)
    tol = bound + rounding * want.float().abs() + 1e-5
    assert ((out.float() - want.float()).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dh,n_head,dtype", [(64, 9, torch.bfloat16), (8, 2, torch.bfloat16),
                                             (80, 2, torch.bfloat16), (768, 1, torch.bfloat16),
                                             (64, 9, torch.float32), (64, 3, torch.float32)])
def test_k5_kernel_on_card(cuda_device, dh, n_head, dtype):  # noqa: F811
    """K5 at head width 64 (K3's device code, or the fp32 kernel; 9 heads:
    d % 128 != 0) and at other widths (its own kernel, bf16), unaligned Tq
    and a masked key tail; the tolerance of K3 in each dtype."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    g = torch.Generator(device=cuda_device).manual_seed(1)
    d = dh * n_head
    q, k, v = (torch.randn((2, t, d), generator=g, device=cuda_device).to(dtype) for t in (37, 150, 150))
    kw = dict(n_head=n_head, kv_valid_len=130, scale=dh**-0.5)
    want = PF.flash_attention_mh_plain(q, k, v, **kw).float()
    reset_launch_counts()
    got = PF.flash_attention_mh(q, k, v, **kw)
    assert LAUNCHES["flash_attention_mh" if dtype == torch.bfloat16 else "flash_attention_mh_f32"] == 1
    assert got.dtype == dtype and torch.equal(PF.flash_attention_mh(q, k, v, **kw), got)
    assert (got.float() - want).abs().max().item() <= FLASH_REL[dtype] * want.abs().max().item()
