"""Head widths 32 and 128 in the port's kernels: the plain versions of K3
with lse, K6, K7 with lse and K8 against the Pallas kernels (interpret
mode), of K1 and K2 against the JAX kernels, and the weights carried
across, at dh 32 (d 128, 4 heads: the h2 residuals hold 4 heads a lane) and
dh 128 (d 256, 2 heads: one head a lane), the rest as SMALL; the wrappers'
routing on the card with the library faked. The window path and a train
step at these widths are in test_torch_head_width_{decode,train}.py, the
kernels against these plain versions on the card in
test_torch_head_width_card.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.models.registry import export_torch_state_dict
from asr_ttl_mtl_tpu.ops import decode_attention as JD
from asr_ttl_mtl_tpu.ops import flash_attention as JF
from asr_ttl_mtl_tpu_torch.models import state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import decode_attention as PD
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF

from torch_port_helpers import SMALL, jax_dims

ATOL = 1e-5  # fp32 both sides; only the order of the sums differs
# head width -> (d, n_head) at the small size
WIDTHS = {32: (128, 4), 128: (256, 2), 80: (160, 2), 96: (192, 2)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=0)


def _geometry(dh):
    d, n_head = WIDTHS[dh]
    return dict(n_audio_state=d, n_audio_head=n_head, n_text_state=d, n_text_head=n_head)


# ------------------------------------------------------- K3 lse and K6 ------


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("tq,tk,kv_valid_len", [(48, 64, 50)])
def test_k3_lse_and_k6_plain_match_pallas(dh, tq, tk, kv_valid_len):
    """The h2 residual layouts (D//128, B, Tq, hpb) at hpb 4 (dh 32) and 1
    (dh 128), and the gradients, against the Pallas kernels."""
    d, n_head = WIDTHS[dh]
    b, hpb = 2, 128 // dh
    q, k, v, g = _inputs([(b, tq, d), (b, tk, d), (b, tk, d), (b, tq, d)], seed=tq + tk + dh)
    kw = dict(n_head=n_head, kv_valid_len=kv_valid_len, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention_h2(q, k, v, return_lse=True, interpret=True, **kw)
        jdelta = (g * np.asarray(jout)).reshape(b, tq, d // 128, hpb, dh).sum(-1).transpose(2, 0, 1, 3)
        jgrads = JF.flash_attention_h2_bwd(q, k, v, jlse, jdelta, g, interpret=True, **kw)
    pout, plse = PF.flash_attention_h2(_t(q), _t(k), _t(v), return_lse=True, **kw)
    assert tuple(plse.shape) == (d // 128, b, tq, hpb) == tuple(np.asarray(jlse).shape)
    _close(pout, jout)
    _close(plse, jlse)
    _close(PF.h2_delta(_t(g), pout, n_head), jdelta)
    pgrads = PF.flash_attention_h2_bwd(_t(q), _t(k), _t(v), plse, _t(jdelta), _t(g), **kw)
    for a, c in zip(pgrads, jgrads):
        _close(a, c)
    if kv_valid_len is not None:  # masked keys get exactly zero gradient
        assert not pgrads[1][:, kv_valid_len:].any() and not pgrads[2][:, kv_valid_len:].any()


# ----------------------------------------------------------- K7 and K8 ------


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("bh,tq,tk,causal,q_offset,kv_valid_len",
                         [(2, 40, 64, True, 7, 60)])
def test_k7_lse_and_k8_plain_match_pallas(dh, bh, tq, tk, causal, q_offset, kv_valid_len):
    q, k, v, g = _inputs([(bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh)], seed=tq * tk + dh)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=dh**-0.5)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = JF.flash_attention(q, k, v, return_lse=True, interpret=True, **kw)
        jgrads = JF.flash_attention_bwd(q, k, v, jout, jlse, g, interpret=True, **kw)
    pout, plse = PF.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    assert tuple(plse.shape) == (bh, tq, 1)
    _close(pout, jout)
    _close(plse, jlse)
    _close(PF.flash_attention(_t(q), _t(k), _t(v), **kw), jout)
    for a, c in zip(PF.flash_attention_bwd(_t(q), _t(k), _t(v), pout, plse, _t(g), **kw), jgrads):
        _close(a, c)


# ----------------------------------------------------------- K1 and K2 ------


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("group,valid", [(1, None), (5, 37)])
def test_k2_and_k1_plain_match_jax(dh, group, valid):
    """K2 over fp32 caches and K1 over int8 caches (tk_blk 128), groups 1
    and 5. K1's tolerance as test_torch_kernels.py's: the plain version's
    flip bound plus fp32 noise."""
    d, n_head = WIDTHS[dh]
    b, tk = 2, 128
    rng = np.random.RandomState(dh + group)
    q = (rng.randn(b * group, 1, d) * 0.5).astype(np.float32)
    ck, cv = (rng.randn(2, b, tk, d).astype(np.float32) for _ in range(2))
    kw = dict(scale=dh**-0.5, valid_upto=valid, group=group)
    want = JD.decode_attention(q, ck, cv, 1, n_head, interpret=True, **kw)
    _close(PD.decode_attention(_t(q), _t(ck), _t(cv), 1, n_head, **kw), want)
    assert PD._i8_blocks(b, tk, d)[1] == 128
    ki, ks = JD.quantize_kv_rows(jnp.asarray(ck))
    vi, vs = JD.quantize_kv_rows(jnp.asarray(cv))
    want = JD.decode_attention_i8(q, ki, ks, vi, vs, 1, n_head, interpret=True, **kw)
    got, flip = PD.decode_attention_i8_plain(_t(q), _t(ki), _t(ks), _t(vi), _t(vs), 1, n_head,
                                             return_flip_bound=True, **kw)
    assert torch.equal(got, PD.decode_attention_i8(_t(q), _t(ki), _t(ks), _t(vi), _t(vs), 1, n_head, **kw))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert np.all(diff <= ATOL + flip.numpy()), (diff - flip.numpy()).max()


# ------------------------------------------------- weights carried across ------


@pytest.mark.parametrize("dh", [32, 128, 80, 96])
def test_state_dict_from_jax_params_matches_export(dh):
    """The port's carrier gives the JAX package's own export, key for key
    and value for value, and loads into the port's model at this width."""
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, WhisperModel

    dims = jax_dims(**_geometry(dh))
    # the tree init_params gives, its shapes traced without running it, with
    # seeded values: the carrier only moves and transposes them
    rng = np.random.RandomState(dh)
    shapes = jax.eval_shape(lambda key: JW.init_params(key, dims), jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: rng.randn(*x.shape).astype(x.dtype), shapes)
    got, want = state_dict_from_jax_params(params, dims), export_torch_state_dict(params, dims)
    assert set(want) <= set(got)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    model = WhisperModel(ModelDimensions(**{**SMALL, **_geometry(dh)}), compute_dtype=torch.float32)
    model.load_state_dict(got)  # strict: every key the port's model has, at its shape


# ------------------------------------- the wrappers' routing on the card ------


class FakeLib:
    """Records each C call (symbol, arguments); every call returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0

        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """The flash wrappers take their card path on CPU tensors, into a FakeLib."""
    lib = FakeLib()
    monkeypatch.setattr(PF, "on_card", lambda *a: True)
    monkeypatch.setattr(PF._cuda, "lib", lambda name: lib)
    monkeypatch.setattr(PF._cuda, "stream_handle", lambda device: 0)
    reset_launch_counts()
    yield lib
    reset_launch_counts()


@pytest.fixture
def fake_decode_card(monkeypatch):
    """K1's and K2's wrappers on meta tensors that call themselves CUDA,
    their launchers replaced by a recorder: the wrappers' checks run, no
    kernel does."""
    calls = []

    def launcher(key):
        def launch(q, *args):
            calls.append((key, args))
            return torch.empty_like(q)

        return launch

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(PD, "_launch_k2", launcher("decode_attention"))
    monkeypatch.setattr(PD, "_launch_k1", launcher("decode_attention_i8"))
    return calls


def _decode_call(dh, dtype, d=None, n_head=None, int8=False):
    d, n_head = (d, n_head) if d is not None else (4 * dh, 4)
    meta = dict(device="meta")
    q = torch.zeros((2, 1, d), dtype=dtype, **meta)
    if int8:
        ck = torch.zeros((1, 2, 128, d), dtype=torch.int8, **meta)
        sc = torch.ones((1, 2, 128), **meta)
        return lambda: PD.decode_attention_i8(q, ck, sc, ck, sc, 0, n_head, scale=1.0)
    ck = torch.zeros((1, 2, 128, d), dtype=dtype, **meta)
    return lambda: PD.decode_attention(q, ck, ck, 0, n_head, scale=1.0)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_wrappers_take_the_head_widths(fake_card, dh):
    """bf16 at dh 32, 64 and 128: K3 allocates lse (D//128, B, Tq, 128 // dh),
    K6 checks residuals of that shape, K7 and K8 pass dh to the C entry, and
    each launch counts once."""
    b, tq, tk, d = 2, 20, 30, 256
    n_head = d // dh
    bf = dict(dtype=torch.bfloat16)
    q, k, g = torch.zeros((b, tq, d), **bf), torch.zeros((b, tk, d), **bf), torch.zeros((b, tq, d), **bf)
    out, lse = PF.flash_attention_h2(q, k, k, n_head=n_head, return_lse=True)
    assert tuple(lse.shape) == (d // 128, b, tq, 128 // dh)
    PF.flash_attention_h2_bwd(q, k, k, lse, torch.zeros_like(lse), g, n_head=n_head)
    with pytest.raises(ValueError, match="lse/delta"):
        PF.flash_attention_h2_bwd(q, k, k, lse[..., :1] if dh < 128 else lse.repeat(1, 1, 1, 2),
                                  torch.zeros_like(lse), g, n_head=n_head)
    qs, ks = torch.zeros((4, tq, dh), **bf), torch.zeros((4, tk, dh), **bf)
    _, lse7 = PF.flash_attention(qs, ks, ks, causal=True, return_lse=True)
    PF.flash_attention_bwd(qs, ks, ks, qs, lse7, qs, causal=True)
    symbols = [name for name, _ in fake_card.calls]
    assert symbols == ["flash_h2_fwd_bf16", "flash_h2_bwd_bf16", "flash_fwd_bf16", "flash_bwd_bf16"]
    assert fake_card.calls[2][1][8] == dh and fake_card.calls[3][1][12] == dh  # the dh argument
    assert {k: n for k, n in LAUNCHES.items() if n} == {"flash_attention_h2_lse": 1, "flash_attention_h2_bwd": 1,
                                                        "flash_attention_lse": 1, "flash_attention_bwd": 1}


@pytest.mark.parametrize("dh,dtype", [(136, torch.bfloat16), (20, torch.bfloat16), (256, torch.bfloat16),
                                      (136, torch.float32), (20, torch.float32), (256, torch.float32)])
def test_flash_wrappers_refuse_other_widths(fake_card, dh, dtype):
    """A width no kernel of the dtype serves raises before any launch,
    naming the widths served: K7 and K8 serve every width from 1 to 768, so
    776 (or 1024) raises there; the fp32 K5 every multiple of 8 up to 768,
    so 20 (or 776) raises there; K3 and K6 serve 32, 64 and 128 only, so 80
    and 96 (and this width) raise there."""
    n_head = 2
    wide = 776 if dh % 8 == 0 else 1024  # a width K7 and K8 refuse
    qw = torch.zeros((4, 20, wide), dtype=dtype)
    lse7 = torch.zeros((4, 20, 1))
    k5_width = dh if dh % 8 else 776  # a width the fp32 K5 refuses
    q = torch.zeros((2, 20, n_head * k5_width), dtype=dtype)
    calls = [(lambda: PF.flash_attention(qw, qw, qw, causal=True), "from 1 to 768"),
             (lambda: PF.flash_attention_bwd(qw, qw, qw, qw, lse7, qw, causal=True), "from 1 to 768")]
    if dtype == torch.float32:  # the bf16 K5's own check names its range (`k5_plan`)
        calls.append((lambda: PF.flash_attention_mh(q, q, q, n_head=n_head), "multiple of 8 from 8 to 768"))
    for call, served in calls:
        with pytest.raises(ValueError, match=served):
            call()
    for width in (80, 96, dh):
        h2_heads = 8 if width == 80 else 4 if width == 96 else n_head
        d = h2_heads * width
        qn = torch.zeros((2, 20, d), dtype=dtype)
        h2_calls = [lambda: PF.flash_attention_h2(qn, qn, qn, n_head=h2_heads)]
        if d % 128 == 0:
            res = torch.zeros((d // 128, 2, 20, max(1, 128 // width)))
            h2_calls.append(lambda: PF.flash_attention_h2_bwd(qn, qn, qn, res, res, qn, n_head=h2_heads))
        for call in h2_calls:
            with pytest.raises(ValueError, match="head width of 32, 64, 128"):
                call()
    assert fake_card.calls == [] and sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("int8", [False, True], ids=["K2", "K1"])
def test_decode_wrappers_take_the_head_widths(fake_decode_card, int8):
    """K1 and K2 take every multiple of 8 from 8 to 768 and widths off a
    multiple of 8 (1, 20, 75, 300) with bf16 and with fp32 q; 776 and 1024
    raise before any launch, naming the range 1-768."""
    widths = [*range(8, 769, 8), 1, 20, 75, 300]
    for dh in widths:
        _decode_call(dh, torch.bfloat16, int8=int8)()
        _decode_call(dh, torch.float32, int8=int8)()
    assert len(fake_decode_card) == 2 * len(widths)
    for dh, dtype in ((776, torch.bfloat16), (1024, torch.bfloat16), (776, torch.float32), (1024, torch.float32)):
        with pytest.raises(ValueError, match="from 1 to 768"):
            _decode_call(dh, dtype, int8=int8)()
    with pytest.raises(ValueError, match="equal heads"):
        _decode_call(64, torch.bfloat16, d=200, n_head=3, int8=int8)()
    assert len(fake_decode_card) == 2 * len(widths)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_k2_plan_fits_shared_memory_at_each_width(dh):
    """The plan's shared memory, the source's k2_smem_bytes at this width,
    fits in a CTA for the paths' groups over one window and a 448-row self
    cache; dh 128 stages 2 tiles of bf16 rows and dh 32 and 64 stage 4."""
    ring = (2 if dh == 128 else 4) * 128 * (2 * dh + 16)
    # group 1: q, 128 scores, 16 key slices of P.V partials, the row statistics, one float a thread
    assert PD.k2_smem_bytes(1, 128, 2, dh) == ring + 4 * (dh + 128 + 16 * dh + 4 + 128)
    for batch, n_keys, group in ((1, 1500, 1), (1, 1500, 5), (8, 1500, 1), (8, 1500, 5), (8, 38, 5), (1, 448, 16)):
        split = PD.k2_plan(batch, 512 // dh, n_keys, group, 2, dh)
        assert PD.k2_smem_bytes(group, -(-n_keys // split), 2, dh) <= 227 * 1024
    assert PD.k2_plan(1, 8, 1500) == PD.k2_plan(1, 8, 1500, 1, 2, 64)  # dh 64 is the default
