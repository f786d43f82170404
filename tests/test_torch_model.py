"""Port model (modules, weight carry, encoder, decoder, caches) against the
JAX package's `models/whisper.py` on the same weights and inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.models.registry import export_torch_state_dict
from asr_ttl_mtl_tpu_torch.models import WhisperModel, from_random, load_model
from asr_ttl_mtl_tpu_torch.models import whisper as PW
from asr_ttl_mtl_tpu_torch.models.dims import PRESET_DIMS

from torch_port_helpers import SMALL, model_pair, np_tree

ATOL = 1e-4  # fp32 both sides; attention and matmul sums in another order


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=0)


def test_presets_match():
    from asr_ttl_mtl_tpu.models.dims import PRESET_DIMS as J

    assert {k: tuple(v.__dict__.values()) for k, v in PRESET_DIMS.items()} == {
        k: tuple(v.__dict__.values()) for k, v in J.items()
    }


def test_weight_carry_equals_export(pair):
    jmodel, tmodel = pair
    from asr_ttl_mtl_tpu_torch.models import state_dict_from_jax_params

    ours = state_dict_from_jax_params(np_tree(jmodel.params), jmodel.dims)
    theirs = export_torch_state_dict(jmodel.params, jmodel.dims)
    assert list(ours) == list(theirs)
    for key in theirs:
        assert ours[key].shape == theirs[key].shape and ours[key].dtype == theirs[key].dtype, key
        assert torch.equal(ours[key], theirs[key]), key
    # the module takes exactly those keys
    assert set(tmodel.state_dict()) == set(theirs)


def test_checkpoint_roundtrip(pair, tmp_path):
    _, tmodel = pair
    path = str(tmp_path / "m.pt")
    torch.save({"dims": tmodel.dims.__dict__, "model_state_dict": tmodel.state_dict()}, path)
    loaded = load_model(path, device="cpu")
    for (k, a), (_, b) in zip(tmodel.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), k


def test_from_random_is_seeded():
    a = from_random(PW.ModelDimensions(**SMALL), seed=3, device="cpu")
    b = from_random(PW.ModelDimensions(**SMALL), seed=3, device="cpu")
    c = from_random(PW.ModelDimensions(**SMALL), seed=4, device="cpu")
    wa, wb, wc = (m.encoder.blocks[0].mlp[0].weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    bound = 1 / np.sqrt(128)
    assert float(wa.abs().max()) <= bound


def _mel(batch=2, seed=0):
    return (np.random.RandomState(seed).randn(batch, 80, 2 * SMALL["n_audio_ctx"]) * 0.5).astype(np.float32)


@pytest.mark.parametrize("int8_linears", [False, True])
def test_encoder_features(pair, int8_linears):
    """fp32 and W8A8 encoders. With int8 projections an fp32-level difference
    can round one activation to the other int8 neighbour, which moves a
    feature by ~1e-3 of its row (LayerNorm output, O(1)): allow 2e-3."""
    jmodel, tmodel = pair
    mel = _mel()
    want = np.asarray(JW.encoder_apply(jmodel.params, jmodel.dims, jnp.asarray(mel), int8_linears=int8_linears))
    got = PW.encoder_apply(tmodel.encoder, torch.from_numpy(mel), int8_linears=int8_linears).numpy()
    assert got.shape == want.shape == (2, SMALL["n_audio_ctx"], SMALL["n_audio_state"])
    np.testing.assert_allclose(got, want, atol=2e-3 if int8_linears else ATOL, rtol=0)


def test_linear_i8_matches():
    rng = np.random.RandomState(1)
    x = rng.randn(40, 128).astype(np.float32)
    w = rng.randn(128, 64).astype(np.float32) * 0.1
    b = rng.randn(64).astype(np.float32)
    want = np.asarray(JW.linear_i8({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    lin = torch.nn.Linear(128, 64).requires_grad_(False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
    got = PW.linear_i8(lin, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_policy(dtype):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(JW._gelu(jx).astype(jnp.float32))
    got = PW.gelu(torch.from_numpy(x).to(dtype)).float().numpy()
    tol = 1e-6 if dtype == torch.float32 else 2.0**-7 * 4
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_sinusoids():
    np.testing.assert_array_equal(PW.sinusoids(96, 128), JW.sinusoids(96, 128))


def _feats(pair):
    jmodel, tmodel = pair
    mel = _mel(seed=5)
    jf = JW.encoder_apply(jmodel.params, jmodel.dims, jnp.asarray(mel))
    return jf, torch.from_numpy(np.array(jf))


@pytest.mark.parametrize("n_tokens", [7, 20])
def test_decoder_teacher_forced(pair, n_tokens):
    jmodel, tmodel = pair
    jf, tf = _feats(pair)
    tokens = np.random.RandomState(2).randint(0, 50000, size=(2, n_tokens))
    want, _, _ = JW.decoder_apply(jmodel.params, jmodel.dims, jnp.asarray(tokens), jf)
    got, cache = PW.decoder_apply(tmodel.decoder, torch.from_numpy(tokens), tf)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_steps(pair, kv_quant):
    """Bucket-8 prefill, then 8 one-token steps through the decode kernels'
    plain versions (JAX: the Pallas kernels in interpret mode)."""
    jmodel, tmodel = pair
    dims = jmodel.dims
    jf, tf = _feats(pair)
    jcross = JW.precompute_cross_kv(jmodel.params, dims, jf, quantize=kv_quant)
    tcross = PW.precompute_cross_kv(tmodel.decoder, tf, quantize=kv_quant)
    for key in jcross:
        np.testing.assert_allclose(tcross[key].float().numpy(), np.asarray(jcross[key], np.float32),
                                   atol=ATOL if not key.endswith("scale") else 1e-6, rtol=0)
    if kv_quant:  # int8 K/V may differ by one step where fp32 noise crosses .5
        assert np.mean(tcross["k"].numpy() == np.asarray(jcross["k"])) > 0.999
        jcross = {k: jnp.asarray(v.numpy()) for k, v in tcross.items()}
    jcache = JW.init_kv_cache_i8(dims, 2, ctx=128) if kv_quant else JW.init_kv_cache(dims, 2, ctx=128)
    tcache = PW.init_kv_cache_i8(tmodel.dims, 2, ctx=128) if kv_quant else PW.init_kv_cache(tmodel.dims, 2, ctx=128)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 50000, size=(2, 8))
    JW.set_decode_kernel("interpret")
    try:
        jl, jcache, _ = JW.decoder_apply(jmodel.params, dims, jnp.asarray(prompt), cross_kv=jcross, kv_cache=jcache)
        tl, tcache = PW.decoder_apply(tmodel.decoder, torch.from_numpy(prompt), cross_kv=tcross, kv_cache=tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        for step in range(8):
            tok = rng.randint(0, 50000, size=(2, 1))
            jl, jcache, _ = JW.decoder_apply(jmodel.params, dims, jnp.asarray(tok), cross_kv=jcross,
                                             kv_cache=jcache, pos_offset=5 + step)
            tl, tcache = PW.decoder_apply(tmodel.decoder, torch.from_numpy(tok), cross_kv=tcross,
                                          kv_cache=tcache, pos_offset=5 + step)
            # int8: the K1 tolerance argument (one v step per flipped p) on
            # logits of O(1): 5e-3
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-3 if kv_quant else ATOL, rtol=0)
    finally:
        JW.set_decode_kernel("auto")


def test_causal_attention_at_tq16_runs_plain_on_cpu():
    """Causal attention at tq >= 16 needs the unported K7 on the card (it
    raises there); on the CPU it runs the plain path, as the JAX package
    does off the TPU."""
    q = torch.randn(1, 20, 128)
    out = PW.qkv_attention(q, q, q, 2, mask=torch.zeros(1, 1, 20, 20), causal=True)
    assert out.shape == q.shape


def test_model_wrapper_shapes():
    m = WhisperModel(PW.ModelDimensions(**SMALL))
    assert m.is_multilingual and not m.has_disease_tokens and m.num_languages == 99
