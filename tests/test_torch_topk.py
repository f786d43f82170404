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


# ------------------------------------------------------------ the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,v,k", [(160, 51865, 6), (7, 1000, 1), (5, 517, 8), (9, 130, 9), (4, 51866, 32)])
def test_topk_kernels_on_card(cuda_device, rows, v, k, dtype):  # noqa: F811
    """Indices exact; values within 4e-6 of max(1, |v|) (K9: the row sum's
    order); K10's values exact."""
    x = torch.from_numpy(np.array(_rows(rows, v, seed=rows + v, dtype="float32"))).to(cuda_device, dtype)
    for kernel, plain, tol in ((PT.topk_logprobs, PT.topk_logprobs_plain, 4e-6), (PT.topk, PT.topk_plain, 0.0)):
        (gv, gi), (pv, pi) = kernel(x, k), plain(x, k)
        torch.cuda.synchronize()
        assert torch.equal(gi, pi)
        fin = torch.isfinite(pv)
        assert torch.equal(torch.isfinite(gv), fin)
        assert bool(((gv - pv).abs() <= tol * pv.abs().clamp(min=1))[fin].all())


@pytest.mark.cuda
def test_topk_kernel_refuses_large_k(cuda_device):  # noqa: F811
    x = torch.randn(2, 100, device=cuda_device)
    with pytest.raises(ValueError):
        PT.topk_logprobs(x, PT.MAX_K + 1)
