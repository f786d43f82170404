"""K9 and K10: the port's plain top-k against the Pallas kernels (interpret
mode on CPU) and `lax.top_k`, plus the CUDA kernels against their plain
versions on the card (marked `cuda`, skipped without one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.ops.pallas_topk import topk_logprobs_pallas, topk_pallas
from asr_ttl_mtl_tpu_torch.ops import LAUNCHES
from asr_ttl_mtl_tpu_torch.ops import topk as PT

from torch_port_helpers import cuda_device  # noqa: F401

VAL_TOL = 1e-6  # fp32 both sides; K9's row sums run in another order


def _rows(b, v, seed, dtype):
    """Seeded logits with suppressed (-inf) lanes, an exact tie at the row
    max, repeated values, a row of one value, a row with fewer than 6
    finite entries and an all -inf row."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, v) * 3).astype(np.float32)
    x[:, 5 : min(v, 40)] = -np.inf
    x[:, [v // 4, v // 2, v - 1]] = x.max(axis=1, keepdims=True) + 1.0
    x[:, v // 3] = x[:, v // 4]
    if b > 2:
        x[1] = -np.inf
        x[1, [7, 3, v - 2]] = 2.0
        x[2] = 1.0
    if b > 3:
        x[3] = -np.inf
    return jnp.asarray(x).astype(dtype)


def _np(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


def _assert_values(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=VAL_TOL, rtol=VAL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,v,k", [(4, 1000, 6), (17, 1111, 6), (5, 517, 1), (6, 130, 8), (3, 4099, 3)])
def test_k9_plain_matches_pallas(b, v, k, dtype):
    """Indices exact against the Pallas kernel and log_softmax + lax.top_k;
    values within 1e-6 (+1e-6 relative: one ulp of a log-prob near -10)."""
    x = _rows(b, v, seed=b * v + k, dtype=dtype)
    want_v, want_i = topk_logprobs_pallas(x, k, interpret=True)
    ref_v, ref_i = jax.lax.top_k(jax.nn.log_softmax(x.astype(jnp.float32), axis=-1), k)
    xt = _np(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got_v, got_i = PT.topk_logprobs(xt, k)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    _assert_values(got_v.numpy(), want_v)
    _assert_values(got_v.numpy(), ref_v)


@pytest.mark.parametrize("b,v,k", [(4, 1000, 6), (3, 130, 2), (8, 128, 1), (5, 517, 8), (2, 51865, 6)])
def test_k10_plain_matches_pallas(b, v, k):
    """Values and indices bit-identical to the Pallas kernel and lax.top_k."""
    x = _rows(b, v, seed=v + k, dtype="float32")
    want_v, want_i = topk_pallas(x, k, interpret=True)
    ref_v, ref_i = jax.lax.top_k(x, k)
    got_v, got_i = PT.topk(_np(x), k)
    for w_v, w_i in ((want_v, want_i), (ref_v, ref_i)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(w_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(w_v))


def test_ties_and_duplicates_listed_lowest_index_first():
    x = np.zeros((4, 300), np.float32)
    x[0, [7, 50, 123]] = 5.0
    x[1, :] = 1.0
    x[2, [299, 0]] = 3.0
    x[3, :] = -np.inf
    got_v, got_i = PT.topk(torch.from_numpy(x), 6)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0, :3].tolist() == [7, 50, 123] and got_i[3].tolist() == [0, 1, 2, 3, 4, 5]


def test_wrappers_take_the_plain_version_on_cpu():
    x = torch.randn(3, 200)
    before = dict(LAUNCHES)
    for fn, plain in ((PT.topk_logprobs, PT.topk_logprobs_plain), (PT.topk, PT.topk_plain)):
        got, want = fn(x, 4), plain(x, 4)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dict(LAUNCHES) == before  # no kernel ran


# ------------------------------------------------ K9's split of a row ----


@pytest.mark.parametrize("rows", [1, 5, 80, 160, 320])
@pytest.mark.parametrize("v", [130, 517, 51865])
def test_k9_plan_covers_each_index_once(rows, v):
    """The plan's slices cover [0, V) exactly once, contiguous, in rank
    order, none empty; and at most K9_MAX_SPLIT CTAs, fewer on a card that
    schedules smaller clusters."""
    split = PT.k9_plan(rows, v)
    assert 1 <= split <= PT.K9_MAX_SPLIT and PT.k9_plan(rows, v, max_split=8) <= 8
    slices = PT.k9_slices(v, split)
    assert len(slices) == split and slices[0][0] == 0 and slices[-1][1] == v
    assert all(lo < hi for lo, hi in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in slices])
    np.testing.assert_array_equal(covered, np.arange(v))


def test_k9_plan_fills_the_card():
    """S 16 at the CLI's 5 rows, 1 at batch mode's 80 and at 160, 2 at 66
    (51865 wide): rows x S within the card's 132 SMs."""
    assert [PT.k9_plan(r, 51865) for r in (5, 66, 80, 160)] == [16, 2, 1, 1]
    assert PT.k9_plan(5, 51865, max_split=8) == 8


def _split_topk_logprobs(x: torch.Tensor, k: int, split: int):
    """The kernel's split, emulated: each slice's (m, s) and its own top-k,
    then the (m, s) combined in rank order and the lists merged by (value
    descending, index ascending)."""
    xf = x.float()
    vals, idx = [], []
    for row in xf:
        ms, cand_v, cand_i = [], [], []
        for lo, hi in PT.k9_slices(row.numel(), split):
            part = row[lo:hi]
            m_c = part.max()
            s_c = torch.exp(part - m_c).sum() if torch.isfinite(m_c) else torch.zeros(())
            ms.append((m_c, s_c))
            top = torch.sort(part, descending=True, stable=True)
            cand_v.append(top.values[:k])
            cand_i.append(top.indices[:k] + lo)
        m = max(m_c for m_c, _ in ms)
        s = torch.zeros(())
        for m_c, s_c in ms:  # rank order
            if torch.isfinite(m_c):
                s = s + s_c * torch.exp(m_c - m)
        cv, ci = torch.cat(cand_v), torch.cat(cand_i)
        order = torch.sort(cv, descending=True, stable=True).indices[:k]  # ties keep rank (index) order
        vals.append((cv[order] - m) - torch.log(s))
        idx.append(ci[order])
    return torch.stack(vals), torch.stack(idx).to(torch.int32)


def _split_rows(v, split, seed):
    """Seeded logits: an exact tie at the top across every slice boundary,
    a duplicate in two slices, a row of all -inf but three entries, and the
    real suppress pattern of -inf lanes."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, v) * 3).astype(np.float32)
    x[:, 5:40] = -np.inf
    top = x.max() + 1.0
    for lo, _ in PT.k9_slices(v, split)[1:]:
        x[0, [lo - 1, lo]] = top
    x[1, [11, v - 7]] = top
    x[1, v // 2] = x[1, 11] - 0.5
    x[2] = -np.inf
    x[2, [v - 1, 3, v // 2]] = 2.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 6, 32])
@pytest.mark.parametrize("v,split", [(4099, 2), (4099, 3), (40000, 16), (51865, None)])
def test_k9_split_matches_pallas(v, split, k, dtype):
    """The slice-then-merge against the Pallas kernel (interpret): indices
    exactly, values within 4e-6 x max(1, |v|); split None is the plan's at
    5 rows (16)."""
    split = split or PT.k9_plan(5, v)
    x = jnp.asarray(_split_rows(v, split, seed=v + k)).astype(dtype)
    want_v, want_i = topk_logprobs_pallas(x, k, interpret=True)
    got_v, got_i = _split_topk_logprobs(_np(x), k, split)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    got_v, want_v = got_v.numpy(), np.asarray(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), np.isfinite(want_v))
    fin = np.isfinite(want_v)
    np.testing.assert_array_less(np.abs(got_v[fin] - want_v[fin]), 4e-6 * np.maximum(1.0, np.abs(want_v[fin])))
    if k >= 2:  # the tie across each boundary, lowest index first
        lo = PT.k9_slices(v, split)[1][0] if split > 1 else None
        if lo is not None:
            assert got_i[0, :2].tolist() == sorted(got_i[0, :2].tolist()) and lo - 1 in got_i[0].tolist()


# ------------------------------------------------------------ the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "rows,v,k",
    [(160, 51865, 6), (80, 51865, 6), (5, 51865, 6), (7, 1000, 1), (5, 517, 8), (9, 130, 9), (4, 51866, 32)],
)
def test_topk_kernels_on_card(cuda_device, rows, v, k, dtype):  # noqa: F811
    """Indices exact; values within 4e-6 of max(1, |v|) (K9: the row sum's
    order); K10's values exact; a second launch gives the same bits. 5 rows
    split each row across a cluster of 16 CTAs (k9_plan)."""
    x = torch.from_numpy(np.array(_rows(rows, v, seed=rows + v, dtype="float32"))).to(cuda_device, dtype)
    for kernel, plain, tol in ((PT.topk_logprobs, PT.topk_logprobs_plain, 4e-6), (PT.topk, PT.topk_plain, 0.0)):
        (gv, gi), (pv, pi) = kernel(x, k), plain(x, k)
        again_v, again_i = kernel(x, k)
        torch.cuda.synchronize()
        # bit for bit, NaN (an all -inf row's log-probabilities) included
        assert torch.equal(again_v.view(torch.int32), gv.view(torch.int32)) and torch.equal(again_i, gi)
        assert torch.equal(gi, pi)
        fin = torch.isfinite(pv)
        assert torch.equal(torch.isfinite(gv), fin)
        assert bool(((gv - pv).abs() <= tol * pv.abs().clamp(min=1))[fin].all())


@pytest.mark.cuda
def test_topk_kernel_refuses_large_k(cuda_device):  # noqa: F811
    x = torch.randn(2, 100, device=cuda_device)
    with pytest.raises(ValueError):
        PT.topk_logprobs(x, PT.MAX_K + 1)
