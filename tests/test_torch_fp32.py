"""fp32 on the card, the parts that run without one: the kernel wrappers'
dtype rule (bf16 and fp32 pick their C symbols and launch counts, mixed
dtypes raise, and so does fp16 for the training kernels, whose fp16 twins
come with the fp16 training slice; the fp16 serving kernels are
tests/test_torch_fp16.py's) with the library and the card faked, and the conv
stem's fp32 convolution under cuDNN without TF32, forward and backward,
while the bf16 call is left as it was; and the precision argument of the
fp32 flash kernels' 3xTF32 products, on an emulation of the TF32 rounding."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from asr_ttl_mtl_tpu_torch.models import whisper as PW
from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF
from asr_ttl_mtl_tpu_torch.ops import int8_mlp as PM


class FakeLib:
    """Records the C symbol a wrapper calls; every call returns 0 (no error)."""

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
    for mod in (PF, PM):
        monkeypatch.setattr(mod, "on_card", lambda *a: True)
        monkeypatch.setattr(mod._cuda, "lib", lambda name: lib)
        monkeypatch.setattr(mod._cuda, "stream_handle", lambda device: 0)
    reset_launch_counts()
    yield lib
    reset_launch_counts()


def _flash_calls(dtype, k_dtype=None):
    """(wrapper call, bf16 symbol, launch key) for K3, K3-lse, K6, K5, K7,
    K7-lse, K8 on zeros of `dtype`, the keys of `k_dtype` if given."""
    b, tq, tk, d, h = 2, 20, 30, 128, 2

    def t(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt)

    q, k, v, g = t(b, tq, d), t(b, tk, d, dt=k_dtype or dtype), t(b, tk, d), t(b, tq, d)
    res = torch.zeros((d // 128, b, tq, 2))
    qs, ks, vs, gs = t(4, tq, 64), t(4, tk, 64, dt=k_dtype or dtype), t(4, tk, 64), t(4, tq, 64)
    lse = torch.zeros((4, tq, 1))
    return {
        "K3": (lambda: PF.flash_attention_h2(q, k, v, n_head=h), "flash_h2_fwd_bf16", "flash_attention_h2"),
        "K3-lse": (lambda: PF.flash_attention_h2(q, k, v, n_head=h, return_lse=True), "flash_h2_fwd_bf16",
                   "flash_attention_h2_lse"),
        "K6": (lambda: PF.flash_attention_h2_bwd(q, k, v, res, res, g, n_head=h), "flash_h2_bwd_bf16",
               "flash_attention_h2_bwd"),
        "K5": (lambda: PF.flash_attention_mh(q, k, v, n_head=h), "flash_mh_fwd_bf16", "flash_attention_mh"),
        "K7": (lambda: PF.flash_attention(qs, ks, vs, causal=True), "flash_fwd_bf16", "flash_attention"),
        "K7-lse": (lambda: PF.flash_attention(qs, ks, vs, return_lse=True), "flash_fwd_bf16",
                   "flash_attention_lse"),
        "K8": (lambda: PF.flash_attention_bwd(qs, ks, vs, qs, lse, gs, causal=True), "flash_bwd_bf16",
               "flash_attention_bwd"),
    }


FLASH = ["K3", "K3-lse", "K6", "K5", "K7", "K7-lse", "K8"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", FLASH)
def test_flash_wrappers_pick_the_symbol_of_the_dtype(fake_card, kernel, dtype):
    call, symbol, key = _flash_calls(dtype)[kernel]
    out = call()
    first = out[0] if isinstance(out, tuple) else out
    assert first.dtype == dtype
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    assert fake_card.called == [symbol.replace("bf16", sfx)]
    counted = key if dtype == torch.bfloat16 else f"{key}_f32"
    assert {k: n for k, n in LAUNCHES.items() if n} == {counted: 1}


@pytest.mark.parametrize("kernel", FLASH)
def test_flash_wrappers_refuse_fp16_and_mixed_dtypes(fake_card, kernel):
    """Mixed dtypes raise for every flash kernel, fp16 for the training ones
    (K3-lse, K6, K7-lse, K8); K3, K5 and K7 serve fp16 (test_torch_fp16.py)."""
    for calls in (_flash_calls(torch.float32, k_dtype=torch.bfloat16),
                  _flash_calls(torch.bfloat16, k_dtype=torch.float32),
                  _flash_calls(torch.float16, k_dtype=torch.bfloat16)):
        with pytest.raises(TypeError, match="of one dtype"):
            calls[kernel][0]()
    if kernel in ("K3-lse", "K6", "K7-lse", "K8"):
        with pytest.raises(TypeError, match="fp16 training slice"):
            _flash_calls(torch.float16)[kernel][0]()
    assert fake_card.called == [] and sum(LAUNCHES.values()) == 0


def test_k5_fp32_serves_head_widths_32_64_and_128(fake_card):
    """The fp32 K5 serves the widths of its classes 32, 64 and 128, every
    multiple of 8 below 128 (80 here, in class 128) and, on the fp32 wide
    forward, every multiple of 8 from 136 to 768 (136 here), as the bf16 K5
    does; 776 raises in both dtypes, naming the widths served."""
    q = torch.zeros((2, 20, 160))
    assert PF.flash_attention_mh(q, q, q, n_head=2).dtype == torch.float32
    wide = torch.zeros((2, 20, 272))
    assert PF.flash_attention_mh(wide, wide, wide, n_head=2).dtype == torch.float32
    assert PF.flash_attention_mh(wide.bfloat16(), wide.bfloat16(), wide.bfloat16(), n_head=2).dtype == torch.bfloat16
    past = torch.zeros((2, 20, 1552))
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 768, got 776"):
        PF.flash_attention_mh(past, past, past, n_head=2)
    with pytest.raises(ValueError, match="multiple of 8 up to 768, got 776"):
        PF.flash_attention_mh(past.bfloat16(), past.bfloat16(), past.bfloat16(), n_head=2)
    assert fake_card.called == ["flash_mh_fwd_f32", "flash_mh_fwd_f32", "flash_mh_fwd_bf16"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("d,hidden,route", [(512, 2048, "wgmma"), (1280, 1280, "mma")])
def test_k14_picks_the_symbol_of_the_dtype(fake_card, d, hidden, route, dtype):
    x = torch.zeros((40, d), dtype=dtype)
    w1q, w2q = torch.zeros((hidden, d), dtype=torch.int8), torch.zeros((d, hidden), dtype=torch.int8)
    s1, b1, s2, b2 = torch.ones(hidden), torch.zeros(hidden), torch.ones(d), torch.zeros(d)
    assert PM.k14_plan(40, d, hidden, x.element_size()).route == route
    assert PM.int8_mlp(x, w1q, s1, b1, w2q, s2, b2).dtype == dtype
    sfx = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}[dtype]
    assert fake_card.called == [f"int8_mlp_{sfx}" if route == "wgmma" else f"int8_mlp_mma_{sfx}"]
    assert {k: n for k, n in LAUNCHES.items() if n} == {"int8_mlp" if sfx == "bf16" else f"int8_mlp_{sfx}": 1}


def test_k14_mma_route_holds_fp32_rows_in_shared_memory():
    """The mma.sync route keeps 32 GELU rows in the activation dtype: fp32
    doubles them, so a width that fits in bf16 may not in fp32."""
    assert PM.k14_mma_smem(1280, 1280, 4) - PM.k14_mma_smem(1280, 1280, 2) == 32 * 2 * 1280
    assert PM.k14_plan(8, 3072, 2048, 2).route == "mma"
    with pytest.raises(ValueError, match="no kernel route"):
        PM.k14_plan(8, 3072, 2048, 4)


# ------------------------------------------------------------ conv stem ----


@pytest.fixture
def conv_spy(monkeypatch):
    """Records cuDNN's allow_tf32 at each F.conv1d and convolution_backward call."""
    seen = {"forward": [], "backward": []}
    conv, back = F.conv1d, torch.ops.aten.convolution_backward

    def conv_spy_fn(*args, **kw):
        seen["forward"].append(torch.backends.cudnn.allow_tf32)
        return conv(*args, **kw)

    class BackSpy:  # the op's other attributes (its overloads) stay reachable
        def __call__(self, *args, **kw):
            seen["backward"].append(torch.backends.cudnn.allow_tf32)
            return back(*args, **kw)

        def __getattr__(self, name):
            return getattr(back, name)

    monkeypatch.setattr(F, "conv1d", conv_spy_fn)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", BackSpy())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # cuDNN's default
    return seen


def test_conv_stem_fp32_runs_without_tf32(conv_spy):
    conv = torch.nn.Conv1d(8, 16, 3)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 20), generator=gen, requires_grad=True)
    out = PW.conv1d(conv, x, stride=2)
    assert conv_spy["forward"] == [False] and torch.backends.cudnn.allow_tf32
    g = torch.randn(out.shape, generator=gen)
    dx, dw = torch.autograd.grad(out, (x, conv.weight), g)
    assert conv_spy["backward"] == [False] and torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        want = torch.nn.functional.conv1d(x, conv.weight, None, stride=2, padding=1) + conv.bias[None, :, None]
    assert torch.equal(out, want)
    ref = torch.nn.functional.conv1d(x, conv.weight, conv.bias, stride=2, padding=1)
    rdx, rdw = torch.autograd.grad(ref, (x, conv.weight), g)
    torch.testing.assert_close((dx, dw), (rdx, rdw), atol=1e-6, rtol=0)


def test_conv_stem_bf16_call_is_unchanged(conv_spy):
    conv = torch.nn.Conv1d(8, 16, 3)
    x = torch.randn((2, 8, 20), generator=torch.Generator().manual_seed(1)).bfloat16()
    out = PW.conv1d(conv, x, stride=1)
    assert conv_spy["forward"] == [True]
    raw = F.conv1d(x, conv.weight.bfloat16(), None, stride=1, padding=1)
    assert torch.equal(out, (raw.float() + conv.bias.float()[None, :, None]).bfloat16())


# ------------------------------------------------------- 3xTF32 precision ---


FP32_REL = 2e-5  # chip_smoke.py's gate on an fp32 kernel: a share of its plain version's largest output


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32` on fp32 values: a 10-bit mantissa, to nearest, ties
    away from zero (half a TF32 ulp added to the magnitude's bits, then the
    13 low bits cut)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from an fp32 register: the 13 low
    mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands and fp32 sums, as the kernels run it: one
    pass (big a big b) or three (small a big b + big a small b + big a big
    b), with x = big + small, big = tf32(x) rounded to nearest and small =
    x - big, of which the tensor cores read the top 19 bits. A product of two
    TF32 values is exact in fp32."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32_cut(a - a_big), _tf32_cut(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def test_tf32_rounding_emulation_is_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 2**-10, -3.0, 0.0])
    assert _tf32_rna(x).tolist() == [1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 1 + 2**-10, -3.0, 0.0]
    assert _tf32_cut(x).tolist() == [1.0, 1 + 2**-10, -1.0, 1.0, 1 + 2**-10, -3.0, 0.0]


def test_3xtf32_products_meet_the_fp32_gate_where_one_tf32_pass_does_not():
    """The precision argument of the fp32 flash kernels (`csrc/flash_attention.cu`
    namespace `f32`): on seeded (2, 128, 64) inputs, the scores q k^T * 0.125
    and P V taken in 3xTF32 stay within FP32_REL of the float64 result's
    largest entry; single-pass TF32 misses it."""
    rng = np.random.RandomState(17)
    q, k, v = (torch.from_numpy(rng.randn(2, 128, 64).astype(np.float32)) for _ in range(3))
    s64 = (q.double() @ k.double().transpose(-1, -2)) * 0.125
    p64 = torch.softmax(s64, dim=-1)
    o64 = p64 @ v.double()
    for passes in (3, 1):
        s = _mm_tf32(q, k.transpose(-1, -2), passes) * 0.125
        o = _mm_tf32(p64.float(), v, passes)
        for what, got, want in (("scores", s, s64), ("P V", o, o64)):
            share = (got.double() - want).abs().max().item() / (FP32_REL * want.abs().max().item())
            assert (share <= 1.0) == (passes == 3), f"{what} in {passes} TF32 pass(es): {share:.3f} of the gate"
