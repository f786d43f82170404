"""K14, the fused W8A8 encoder MLP: the port's plain version against the
Pallas kernel (interpret mode on the CPU), its gate against the JAX gate,
and the W8A8 encoder with the switch on against the JAX composition.

The port's tanh GELU is PyTorch's: computed in fp32 from the bf16 input and
rounded to bf16 once. JAX on the CPU rounds each operation of its bf16
GELU to bf16, which moves a GELU output by a few bf16 steps and flips
about 5% of the second int8 intermediate by 1-2 steps. So the int8
intermediates are held against the kernel body written in JAX with the
GELU rounded once, and the output against the Pallas kernel itself within
the JAX test's own bounds (tests/test_int8_mlp.py:54-60)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.ops import int8_mlp as JM
from asr_ttl_mtl_tpu_torch.models import whisper as PW
from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import int8_mlp as PM

from torch_port_helpers import model_pair

_F32 = jnp.float32


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.array(a))


def _case(n, d, h, dtype, seed=0):
    """Seeded bf16 or fp32 MLP weights and input rows, as the JAX test makes
    them; the JAX kernel's arguments and the port's ((out, in) weights)."""
    rng = np.random.default_rng(seed)
    w1 = jnp.asarray(rng.standard_normal((d, h), dtype=np.float32) * 0.05, dtype)
    b1 = jnp.asarray(rng.standard_normal(h, dtype=np.float32) * 0.1, dtype)
    w2 = jnp.asarray(rng.standard_normal((h, d), dtype=np.float32) * 0.05, dtype)
    b2 = jnp.asarray(rng.standard_normal(d, dtype=np.float32) * 0.1, dtype)
    x = jnp.asarray(rng.standard_normal((2, n // 2, d), dtype=np.float32) * 0.5, dtype)
    w1q, s1 = JW._quant_colwise_sym(w1.astype(_F32))
    w2q, s2 = JW._quant_colwise_sym(w2.astype(_F32))
    jargs = (x, w1q, s1, b1.astype(_F32), w2q, s2, b2.astype(_F32))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    targs = (_t(x).to(tdt), _t(w1q).T.contiguous(), _t(s1).reshape(-1), _t(b1).float(),
             _t(w2q).T.contiguous(), _t(s2).reshape(-1), _t(b2).float())
    return jargs, targs


def _jax_body(x, w1q, s1, b1, w2q, s2, b2):
    """`_int8_mlp_kernel`'s steps in JAX, the GELU rounded to the compute
    dtype once: (qx, qg) int8."""
    cdt = x.dtype
    qx, sx = JM._quant_rows(x.reshape(-1, x.shape[-1]).astype(_F32))
    a1 = jnp.matmul(qx, w1q, preferred_element_type=jnp.int32)
    f1 = a1.astype(_F32) * (sx * s1) + b1
    g = jax.nn.gelu(f1.astype(cdt).astype(_F32), approximate=True).astype(cdt).astype(_F32)
    qg, _ = JM._quant_rows(g)
    return np.asarray(qx), np.asarray(qg)


@pytest.mark.parametrize("n,d,h,dtype", [(256, 256, 1024, jnp.bfloat16), (300, 256, 1024, jnp.bfloat16),
                                         (200, 128, 512, jnp.float32)])
def test_plain_matches_pallas(n, d, h, dtype):
    jargs, targs = _case(n, d, h, dtype)
    want = np.asarray(JM.int8_mlp(*jargs, interpret=True), np.float32)
    got, qx, qg, _ = PM.int8_mlp_plain(*targs, return_int8=True)
    got = got.float().numpy()
    assert got.shape == want.shape

    # the int8 intermediates: equal but for one-step flips where fp32
    # sums in another order cross a rounding midpoint
    jqx, jqg = _jax_body(*jargs)
    for mine, theirs in ((qx.numpy(), jqx), (qg.numpy(), jqg)):
        flips = np.abs(mine.astype(np.int32) - theirs.astype(np.int32))
        assert flips.max() <= 1 and flips.mean() < 1e-3, (flips.max(), flips.mean())

    diff = np.abs(got - want)
    scale = np.abs(want).mean() + 1e-6
    if dtype == jnp.bfloat16:
        assert diff.max() / scale < 0.12, (diff.max(), scale)
        assert diff.mean() / scale < 0.02
        cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos > 0.9995
    else:
        assert diff.max() / scale < 0.05


def test_plain_takes_the_tanh_gelu_in_fp32():
    """The TPU kernel's GELU is the tanh form in every dtype; the encoder's
    unfused fp32 GELU is exact erf. Against the kernel the plain version is
    exact up to sum order, while the erf composition is not."""
    jargs, targs = _case(200, 128, 512, jnp.float32, seed=3)
    want = np.asarray(JM.int8_mlp(*jargs, interpret=True))
    got = PM.int8_mlp_plain(*targs).numpy()
    assert np.abs(got - want).max() < 1e-5
    fc1, fc2 = torch.nn.Linear(128, 512), torch.nn.Linear(512, 128)
    with torch.no_grad():
        fc1.weight.copy_(torch.from_numpy(np.asarray(jargs[1] * jargs[2]).T.copy()))
        fc1.bias.copy_(targs[3])
        fc2.weight.copy_(torch.from_numpy(np.asarray(jargs[4] * jargs[5]).T.copy()))
        fc2.bias.copy_(targs[6])
        erf = PW.linear_i8(fc2, PW.gelu(PW.linear_i8(fc1, targs[0]))).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_gate_same_rule():
    for d in (128, 256, 384, 500, 512, 640, 768, 1280):
        for hidden in (4 * d, 2000, 512, 5120):
            for n in (4, 8, 192 * 1536):
                assert PM.int8_mlp_supported(n, d, hidden) == JM.int8_mlp_supported(n, d, hidden), (n, d, hidden)


# ------------------------------------------------ K14's plan (no card) ----

GATE_SHAPES = [(d, h) for d in range(128, 8192 + 1, 128) for h in range(128, 4096 + 1, 128)
               if PM.int8_mlp_supported(8, d, h)]


@pytest.mark.parametrize("d_lo,d_hi", [(128, 512), (640, 1024), (1152, 2048), (2176, 8192)])
def test_k14_plan_over_the_gate(d_lo, d_hi):
    """Every (d, hidden) the gate admits with d in the band: the route fits
    in a block's shared memory with a portable cluster; on the wgmma route
    the two hidden halves' tiles and output tiles cover hidden and d once
    each, the ring has the most stages (2-4) that fit, and all of a row
    tile's int8 GELU chunks (8 KB each) fit where the larger half's bf16
    GELU tiles (16 KB each) were. A shape neither route holds was refused
    by the mma.sync kernel too."""
    seen = 0
    for d, h in GATE_SHAPES:
        if not d_lo <= d <= d_hi:
            continue
        seen += 1
        try:
            plan = PM.k14_plan(8, d, h)
        except ValueError:
            assert PM.k14_mma_smem(d, h) > PM.MAX_SMEM, (d, h)
            assert d > PM.K14_MAX_D or PM.k14_sm90_smem(d, h, 2) > PM.MAX_SMEM, (d, h)
            continue
        assert plan.smem <= PM.MAX_SMEM and 1 <= plan.cluster <= 8, (d, h, plan)
        if plan.route == "mma":
            assert d > PM.K14_MAX_D or PM.k14_sm90_smem(d, h, 2) > PM.MAX_SMEM, (d, h)
            assert plan.smem == PM.k14_mma_smem(d, h), (d, h)
            continue
        tiles, out_tiles = h // 128, d // 128
        own = [list(range(half, tiles, 2)) for half in (0, 1)]
        outs = [list(range(half, out_tiles, 2)) for half in (0, 1)]
        assert sorted(own[0] + own[1]) == list(range(tiles)) and sorted(outs[0] + outs[1]) == list(range(out_tiles))
        assert plan.hidden_per_cta == len(own[0]) * 128 and plan.out_per_cta == len(outs[0]) * 128
        assert plan.smem == PM.k14_sm90_smem(d, h, plan.stages) and 2 <= plan.stages <= 4
        assert plan.stages == 4 or PM.k14_sm90_smem(d, h, plan.stages + 1) > PM.MAX_SMEM
        assert tiles * 64 * 128 <= len(own[0]) * 64 * 128 * 2
        assert plan.cluster * plan.rows_per_cta == 256  # 2 row tiles x 2 halves of 64 rows
    assert seen


@pytest.mark.parametrize("d,h", [(128, 512), (256, 1024), (384, 1536), (512, 2048), (128, 640)])
def test_k14_slot_order_gives_the_second_product(d, h):
    """GEMM2 as the wgmma route runs it: each half's output tiles (half,
    half + 2, ...) summed over its chunk slots in `k14_slot_tiles` order,
    own tiles then the peer's, equal the whole int32 product; and the
    in-place requantization writes slot j (8 KB at 8j KB) only inside GELU
    tiles already read (tile j at 16j KB)."""
    rng = np.random.RandomState(d + h)
    qg = torch.from_numpy(rng.randint(-127, 128, size=(64, h)).astype(np.int32))
    w2 = torch.from_numpy(rng.randint(-127, 128, size=(d, h)).astype(np.int32))
    want = qg @ w2.t()
    got = torch.zeros_like(want)
    for half in (0, 1):
        order = PM.k14_slot_tiles(h, half)
        n_own = len(range(half, h // 128, 2))
        assert sorted(order) == list(range(h // 128)) and order[:n_own] == list(range(half, h // 128, 2))
        for o in range(half, d // 128, 2):
            cols = slice(o * 128, o * 128 + 128)
            for t in order:
                k = slice(t * 128, t * 128 + 128)
                got[:, cols] += qg[:, k] @ w2[cols, k].t()
        for j in range(n_own):  # slot j's bytes lie in GELU tiles 0 .. j
            assert (8 * j + 8) <= 16 * (j + 1) and 8 * j >= 16 * (j // 2)
    assert torch.equal(got, want)


def test_encoder_with_the_switch_on_matches_jax_composition():
    """On the CPU the JAX gate is off (it needs a TPU) and the port's needs
    the card: with the switch on, both encoders run the linear_i8
    composition and agree as test_torch_model's W8A8 case does (2e-3)."""
    jmodel, tmodel = model_pair()
    mel = (np.random.RandomState(0).randn(2, 80, 192) * 0.5).astype(np.float32)
    want = np.asarray(JW.encoder_apply(jmodel.params, jmodel.dims, jnp.asarray(mel), int8_linears=True))
    PW.set_int8_mlp_kernel("auto")
    try:
        reset_launch_counts()
        got = PW.encoder_apply(tmodel.encoder, torch.from_numpy(mel), int8_linears=True).numpy()
    finally:
        PW.set_int8_mlp_kernel("off")
    assert LAUNCHES["int8_mlp"] == 0
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    with pytest.raises(ValueError):
        PW.set_int8_mlp_kernel("interpret")

