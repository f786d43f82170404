"""K5, the per-head natural-layout attention, and the attention dispatch at
the shapes `h2_eligible` rejects: the port's plain K5 against the Pallas
kernel (interpret mode on the CPU) up to one head of 768, `k5_plan` at
every head width K5 serves, `mh_flash_eligible` against the JAX rule, the
route `qkv_attention` picks against the JAX one, and the encoder,
decoder and a train step at a 2-layer d=192, 3-head geometry (head width
64, 192 % 128 != 0) against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.ops import flash_attention as JF
from asr_ttl_mtl_tpu_torch.models import whisper as PW
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF

from torch_port_helpers import DEBUG_DIMS, TRAIN_CONFIG, model_pair, np_tree

WIDE = dict(n_audio_state=192, n_audio_head=3, n_text_state=192, n_text_head=3)
ATOL = 1e-4  # fp32 both sides; attention and matmul sums in another order (as test_torch_model)


def _inputs(b, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, tq, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, tk, d) * 0.3).astype(np.float32)
    v = rng.randn(b, tk, d).astype(np.float32)
    return q, k, v


# ---------------------------------------------------------------- K5 ------


@pytest.mark.parametrize(
    "dh,n_head,tq,tk,kv_valid_len,dtype",
    [(8, 2, 37, 100, 90, "f32"), (64, 3, 130, 200, 150, "f32"), (80, 2, 20, 130, None, "f32"),
     (64, 3, 48, 96, 80, "bf16"), (80, 2, 37, 100, 90, "bf16"), (8, 2, 16, 40, None, "bf16"),
     # route B's widths: slabs of 128 output columns, the last one ragged
     (136, 2, 37, 100, 90, "f32"), (256, 3, 20, 64, 50, "f32"), (768, 1, 40, 130, 101, "f32"),
     (136, 2, 37, 100, 90, "bf16"), (256, 3, 20, 64, 50, "bf16"), (768, 1, 40, 130, 101, "bf16")],
)
def test_k5_plain_matches_pallas(dh, n_head, tq, tk, kv_valid_len, dtype):
    """fp32 at 2e-5; bf16 at 3e-2, the JAX test's own bounds
    (tests/test_flash_attention.py:120-146): p and the output round to
    bf16 on both sides."""
    d = dh * n_head
    q, k, v = _inputs(2, tq, tk, d, seed=dh + tq)
    kw = dict(n_head=n_head, kv_valid_len=kv_valid_len, scale=dh**-0.5)
    if dtype == "bf16":
        tq_, tk_, tv_ = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
        jargs = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (tq_, tk_, tv_)]
        tol = 3e-2
    else:
        tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
        jargs = [jnp.asarray(x) for x in (q, k, v)]
        tol = 2e-5
    want = np.asarray(JF.flash_attention_mh(*jargs, interpret=True, **kw), np.float32)
    got = PF.flash_attention_mh(tq_, tk_, tv_, **kw)
    assert got.dtype == tv_.dtype and tuple(got.shape) == (2, tq, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dh", range(8, 769, 8))
def test_k5_plan_at_every_width(dh):
    """k5_plan at each head width K5 serves (d = dh x n_head <= 768): the
    width classes on K3's 3-D maps, the other widths up to 120 on route A
    at their class, 136-768 on route B with slabs x 128 >= dh; every plan
    within a block's 227 KB and at least 2 stages, route B's bytes at least
    its Q tile and stages of K tiles and V slabs."""
    for tq in (16, 64, 65, 200, 1536):
        plan = PF.k5_plan(dh, tq)
        assert plan.rows == (64 if tq <= 64 or (dh > 128 and -(-dh // 64) > 4) else 128), plan
        assert 2 <= plan.stages <= 4 and plan.smem <= 227 * 1024, plan
        if dh in (32, 64, 128):
            assert plan.route == "class" and plan.width == dh, plan
        elif dh <= 128:
            assert plan.route == "A" and plan.width == min(c for c in (32, 64, 128) if c >= dh), plan
            assert plan.keys == (64 if plan.width == 128 else 128), plan
        else:
            boxes = -(-dh // 64)
            assert plan.route == "B" and plan.width * 128 >= dh > (plan.width - 1) * 128, plan
            assert plan.keys == (64 if boxes <= 6 else 32), plan
            assert plan.smem >= plan.rows * boxes * 128 + plan.stages * plan.keys * (boxes + 2) * 128, plan


@pytest.mark.parametrize("dh", [0, 4, 20, 132, 770, 776, 1024])
def test_k5_plan_refuses_other_widths(dh):
    with pytest.raises(ValueError, match="multiple of 8 up to 768"):
        PF.k5_plan(dh, 200)


def test_mh_flash_eligible_same_rule():
    for tq in (8, 16, 1536):
        for tk in (96, 2048, 2049):
            for d, n_head in ((512, 8), (576, 9), (192, 3), (64, 1), (768, 1), (776, 1), (1280, 20), (96, 3),
                              (100, 4), (160, 2), (16, 2)):
                for causal in (False, True):
                    args = (tq, tk, d, n_head, causal)
                    assert PF.mh_flash_eligible(*args) == JF.mh_flash_eligible(*args), args


# ------------------------------------------------------------ dispatch ------


class _TpuJax:
    """`jax` as the JAX model module sees it, with a TPU backend, so that its
    `_flash_eligible` gate holds on the CPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


# queries below and at 16; keys within and past mh_flash_eligible's 2048;
# geometries h2_eligible serves (512/8, 1280/20) or not (576/9, 64/1), head
# widths 768 and 776 (one over K5's widest), 32 (h2 refuses d=96)
ROUTE_SHAPES = [(8, 40), (16, 40), (16, 2100)]
ROUTE_GEOMETRIES = [(512, 8), (576, 9), (64, 1), (768, 1), (776, 1), (1280, 20), (96, 3)]


def test_qkv_attention_routes_as_jax(monkeypatch):
    """Over (tq, tk, d, n_head, causal, mask): the port calls the wrapper
    the JAX package calls (spies return zeros), or neither."""
    routes = {}

    def spy(side, name):
        def run(q, *args, **kw):
            routes[side] = (name, args[2] if name == "flash" else None)  # flash: (q, k, v, causal, ...)
            return jnp.zeros_like(q) if side == "jax" else torch.zeros_like(q)
        return run

    monkeypatch.setattr(JW, "jax", _TpuJax())
    monkeypatch.setattr(JF, "flash_attention_mh_vjp", spy("jax", "mh"))
    monkeypatch.setattr(JF, "flash_attention_vjp", spy("jax", "flash"))
    monkeypatch.setattr(PW, "flash_attention_mh_vjp", spy("port", "mh"))
    monkeypatch.setattr(PW, "flash_attention_vjp", spy("port", "flash"))
    seen = set()
    for tq, tk in ROUTE_SHAPES:
        for d, n_head in ROUTE_GEOMETRIES:
            for causal, with_mask in ((False, False), (True, True), (True, False), (False, True)):
                q, k = np.zeros((1, tq, d), np.float32), np.zeros((1, tk, d), np.float32)
                mask = np.zeros((tq, tk), np.float32) if with_mask else None
                routes.clear()
                JW.qkv_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), n_head,
                                 mask=None if mask is None else jnp.asarray(mask), causal=causal)
                PW.qkv_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k), n_head,
                                 mask=None if mask is None else torch.from_numpy(mask), causal=causal)
                case = (tq, tk, d, n_head, causal, with_mask)
                assert routes.get("port") == routes.get("jax"), (case, routes)
                seen.add(routes.get("port", ("plain", None))[0])
    assert seen == {"mh", "flash", "plain"}


@pytest.mark.parametrize("tq,tk,d,n_head", [(40, 1500, 576, 9), (1536, 1536, 512, 8), (32, 96, 80, 1)])
def test_mh_vjp_picks_as_jax(monkeypatch, tq, tk, d, n_head):
    """flash_attention_mh_vjp: the K3 pair where `h2_eligible` holds, else K5
    without a gradient and K7 with lse (K8 backward) under autograd."""
    calls = []
    for name in ("flash_attention_h2_vjp", "flash_attention_mh", "flash_attention"):
        real = getattr(PF, name)
        monkeypatch.setattr(PF, name, lambda *a, _n=name, _f=real, **kw: (calls.append(_n), _f(*a, **kw))[1])
    q, k, v = (torch.zeros(1, t, d) for t in (tq, tk, tk))
    PF.flash_attention_mh_vjp(q, k, v, n_head, None, 0.125)
    q.requires_grad_(True)
    PF.flash_attention_mh_vjp(q, k, v, n_head, None, 0.125)
    if JF.h2_eligible(tq, tk, d, n_head):
        assert calls == ["flash_attention_h2_vjp"] * 2
    else:
        assert calls == ["flash_attention_mh", "flash_attention"]


# ------------------------------------------------------ model and trainer ---


@pytest.fixture(scope="module")
def wide_pair():
    return model_pair(seed=1, **WIDE)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: (calls.append(kw.get("causal")), real(*a, **kw))[1])
    return calls


def test_encoder_and_decoder_match_jax_at_non_h2_geometry(wide_pair, monkeypatch):
    jmodel, tmodel = wide_pair
    mh = _count_calls(monkeypatch, PF, "flash_attention_mh")
    k7 = _count_calls(monkeypatch, PF, "flash_attention")
    mel = (np.random.RandomState(0).randn(2, 80, 192) * 0.5).astype(np.float32)
    jf = JW.encoder_apply(jmodel.params, jmodel.dims, jnp.asarray(mel))
    got = PW.encoder_apply(tmodel.encoder, torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(jf), atol=ATOL, rtol=0)
    assert len(mh) == 2 and not k7  # both encoder layers, 128 queries and keys (96 valid)

    tokens = np.random.RandomState(2).randint(0, 50000, size=(2, 20))
    want, _, _ = JW.decoder_apply(jmodel.params, jmodel.dims, jnp.asarray(tokens), jf)
    logits, _ = PW.decoder_apply(tmodel.decoder, torch.from_numpy(tokens), torch.from_numpy(np.array(jf)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert len(mh) == 4 and k7 == [True, True]  # cross-attention K5, causal self-attention K7


def test_train_step_grads_match_jax_at_non_h2_geometry(tmp_path, monkeypatch):
    """One step of both trainers from the same carried weights, batch and
    dropout mask: the loss and every parameter group's gradient norm, as
    test_torch_trainer holds them (1e-4 relative). The port's non-causal
    attention takes K7 with lse and K8 over split heads there."""
    from asr_ttl_mtl_tpu.mtl import MultiTaskTrainer as JTrainer
    from asr_ttl_mtl_tpu.mtl import TrainingConfig as JConfig
    from asr_ttl_mtl_tpu_torch.models import state_dict_from_jax_params
    from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of
    from asr_ttl_mtl_tpu_torch.mtl.trainer import classifier_state_from_jax
    from test_torch_trainer import REL, _batches, _jax_grad_fn, _jax_step

    config = {**TRAIN_CONFIG, "debug_dims": {**DEBUG_DIMS, **WIDE}}
    jtr = JTrainer(JConfig(**config, save_dir=str(tmp_path / "jax")), verbose=False)
    ptr = MultiTaskTrainer(TrainingConfig(**config, device="cpu", save_dir=str(tmp_path / "port")), verbose=False)
    ptr.load_state(state_dict_from_jax_params(np_tree(jtr.model.params), jtr.model.dims),
                   classifier_state_from_jax(np_tree(jtr.classifier_params)))
    batch = _batches(tmp_path, seed=14, n_batches=1)[0]
    jloss, _, keep, jnorms = _jax_step(jtr, batch, _jax_grad_fn(jtr))
    fwd = _count_calls(monkeypatch, PF, "flash_attention")
    bwd = _count_calls(monkeypatch, PF, "flash_attention_bwd")
    ploss, _ = ptr.train_step(batch, keep=torch.from_numpy(np.array(keep)))
    assert float(ploss) == pytest.approx(jloss, rel=REL)
    pnorms = {}
    for name, p in ptr.named_trainable():
        pnorms[group_of(name)] = pnorms.get(group_of(name), 0.0) + float((p.grad.double() ** 2).sum())
    assert set(pnorms) == set(jnorms)
    for key in jnorms:
        assert np.sqrt(pnorms[key]) == pytest.approx(jnorms[key], rel=REL), key
    # 2 encoder + 2 cross-attention layers non-causal, 2 causal self-attention layers
    assert fwd.count(False) == 4 and fwd.count(True) == 2
    assert bwd.count(False) == 4 and bwd.count(True) == 2
