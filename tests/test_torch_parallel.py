"""Multi-device serving: the port's ("dp", "tp") mesh, its Megatron rules,
`decode_batched_dp`, `transcribe_batch(mesh=...)` and the CLI's `--dp` /
`--tp`, against the JAX package on the 8 virtual devices of
tests/conftest.py (mirroring tests/test_parallel.py:186-361 and
tests/test_parallel_hardening.py:75-162).

The port runs on 2 ranks over gloo, spawned once for the module
(`parallel.launch.run_ranks`, meeting through a FileStore in a temporary
directory); the ranks run tests/torch_parallel_workers.py while the JAX
side runs here. 2 layers, d 128 with 2 heads, fp32 both sides: tokens and
texts equal, log-probs within 1e-4 (1e-3 with the W8A8 encoder, as in
tests/test_torch_decoding.py).
"""

import importlib
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.decoding import DecodingOptions as JOptions
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.models.registry import WhisperModel as JaxWhisperModel
from asr_ttl_mtl_tpu.parallel import create_mesh as jax_mesh
from asr_ttl_mtl_tpu.parallel.mesh import _tp_spec_for_path
from asr_ttl_mtl_tpu.parallel.serving import decode_batched_dp as jax_decode_batched_dp
from asr_ttl_mtl_tpu_torch.models import ModelDimensions as TorchDims
from asr_ttl_mtl_tpu_torch.models import WhisperModel, checkpoint_dict, from_random, state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.parallel import mesh as PM
from asr_ttl_mtl_tpu_torch.parallel.launch import run_ranks

from test_torch_batch import BATCH_COMMON, EMBED_SCALE, _compare_outputs
from test_torch_transcribe import DIMS as LONG_DIMS, SR, _tones, _write_wav
from torch_port_helpers import SMALL, jax_dims, model_pair, np_tree
from torch_parallel_workers import serve_cases

JT = importlib.import_module("asr_ttl_mtl_tpu.transcribe")
LP_TOL = 1e-4
I8_LP_TOL = 1e-3  # the W8A8 encoder: an fp32-level difference can move an activation to the next int8 step
DECODE = dict(language="en", sample_len=10, fp16=False)
DECODE_CASES = [  # (name, mesh, options)
    ("dp-greedy", (2, 1), DECODE),
    ("dp-beam", (2, 1), dict(DECODE, beam_size=2)),
    ("dp-kv_quant", (2, 1), dict(DECODE, kv_quant=True)),
    ("dp-kv_quant-int8_encoder", (2, 1), dict(DECODE, kv_quant=True, int8_encoder=True)),
    ("tp-greedy", (1, 2), DECODE),
    ("tp-kv_quant-int8_encoder", (1, 2), dict(DECODE, kv_quant=True, int8_encoder=True)),
    ("tp-beam-kv_quant", (1, 2), dict(DECODE, beam_size=2, kv_quant=True)),
]
BATCH_KW = dict(BATCH_COMMON, temperature=0.0, language="en")
BATCH_CASES = [  # (name, mesh, transcribe_batch keywords)
    ("batch-dp", (2, 1), BATCH_KW),
    ("batch-dp-words", (2, 1), dict(BATCH_KW, beam_size=2, word_timestamps=True)),
    ("batch-tp", (1, 2), dict(BATCH_KW, kv_quant=True)),
]
CLI_COMMON = ["--language", "en", "--batch_mode", "True", "--fp16", "False", "--verbose", "False",
              "--temperature_increment_on_fallback", "None", "--beam_size", "2"]
DOLL = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
            n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1)


def _jax_plain(fn, *args, **kw):
    JW.set_decode_kernel("off")  # the JAX side takes its plain path, as tests/test_torch_batch.py does
    try:
        return fn(*args, **kw)
    finally:
        JW.set_decode_kernel("auto")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the ranks' results, the JAX results, paths): the ranks run in a
    background thread while JAX computes here."""
    tmp = tmp_path_factory.mktemp("parallel_serving")
    jmodel, tmodel = model_pair(seed=3)
    mel = np.random.RandomState(4).randn(3, 80, 2 * SMALL["n_audio_ctx"]).astype(np.float32) * 0.5

    dims = jax_dims(**LONG_DIMS)
    params = JW.init_params(jax.random.PRNGKey(2), dims)
    params["decoder"]["token_embedding"] = params["decoder"]["token_embedding"] * EMBED_SCALE
    batch_jmodel = JaxWhisperModel(dims=dims, params=params, compute_dtype=jnp.float32)
    batch_state = state_dict_from_jax_params(np_tree(params), dims)
    audios = [_tones(45.0, seed=5), _tones(8.0, seed=6), _tones(3.0, seed=7)]

    ckpt = str(tmp / "doll.pt")
    torch.save(checkpoint_dict(from_random(TorchDims(**DOLL), seed=0, device="cpu")), ckpt)
    wavs = []
    for seed in (1, 2, 3):
        wavs.append(str(tmp / f"clip{seed}.wav"))
        _write_wav(wavs[-1], np.random.RandomState(seed).randn(SR).astype(np.float32) * 0.1)
    base = wavs + ["--model", ckpt, "--device", "cpu"] + CLI_COMMON
    cli_cases = [("cli-dp", base + ["--dp", "2"]), ("cli-tp", base + ["--tp", "2"])]

    payload = dict(state=tmodel.state_dict(), dims=SMALL, mel=mel, decode_cases=DECODE_CASES,
                   sampled=dict(DECODE, temperature=0.7, best_of=2),
                   batch_state=batch_state, batch_dims={**SMALL, **LONG_DIMS}, audios=audios,
                   batch_cases=BATCH_CASES, cli_cases=cli_cases, cli_root=str(tmp))
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(serve_cases, 2, payload, store_dir=str(tmp), timeout=900)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test thread below
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_out = {}
        for name, shape, opts in DECODE_CASES:
            jax_out[name] = _jax_plain(jax_decode_batched_dp, jmodel, mel, JOptions(**opts), mesh=jax_mesh(shape))
        for name, shape, kw in BATCH_CASES:
            jax_out[name] = _jax_plain(JT.transcribe_batch, batch_jmodel, audios, mesh=jax_mesh(shape), **kw)
        from asr_ttl_mtl_tpu.cli import cli as jax_cli

        argv = sys.argv
        sys.argv = ["asr_ttl_mtl_tpu"] + wavs + ["--model", ckpt, "--output_dir", str(tmp / "jax_cli"), "--dp", "2"] \
            + CLI_COMMON
        try:
            _jax_plain(jax_cli)
        finally:
            sys.argv = argv
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return ranks["out"], jax_out, tmp, wavs


def _compare_decodes(jres, tres, lp_tol):
    assert len(tres) == len(jres)
    for j, (tokens, avg_lp, no_speech, text) in zip(jres, tres):
        assert tokens == j.tokens and text == j.text
        assert abs(avg_lp - j.avg_logprob) <= lp_tol
        assert abs(no_speech - j.no_speech_prob) <= LP_TOL


def test_tp_rules_match_jax():
    """The dim tp splits of every parameter of the model, against the spec
    JAX `_tp_spec_for_path` gives the same leaf (JAX weights are (in, out),
    the port's (out, in))."""
    dims = jax_dims()
    params = JW.init_params(jax.random.PRNGKey(0), dims)
    names = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        names["/".join(keys)] = (_tp_spec_for_path(path, leaf), leaf.ndim)
    sd = state_dict_from_jax_params(np_tree(params), dims)
    layer = {"fc1": "0", "fc2": "2"}  # mlp/fc1 -> mlp.0
    checked = 0
    for jname, (spec, ndim) in names.items():
        parts = jname.split("/")
        torch_name = ".".join(layer.get(p, p) for p in parts[:-1]) + "." + {"w": "weight", "b": "bias"}.get(
            parts[-1], parts[-1])
        if torch_name not in sd:  # embeddings and positions are named otherwise; JAX replicates them
            assert tuple(spec) == ()
            continue
        jax_dim = next((i for i, a in enumerate(spec) if a == "tp"), None)
        want = None if jax_dim is None else (1 - jax_dim if ndim == 2 else 0)
        assert PM.tp_dim(torch_name) == want, torch_name
        checked += want is not None
    # every leaf JAX splits was found and agrees, and the port splits no other
    assert checked == sum("tp" in tuple(spec) for spec, _ in names.values()) == sum(
        PM.tp_dim(n) is not None for n in sd)


def test_shard_widths_and_cache(served):
    ranks, _, _, _ = served
    shard = ranks[0]["shard"]
    assert shard["encoder.blocks.0.attn.query.weight"] == (64, 128)
    assert shard["encoder.blocks.0.attn.out.weight"] == (128, 64)
    assert shard["decoder.blocks.1.mlp.0.weight"] == (256, 128)
    assert shard["decoder.blocks.1.mlp.2.weight"] == (128, 256)
    assert shard["decoder.blocks.1.mlp.2.bias"] == (128,)  # row-parallel bias: replicated, added once
    assert shard["decoder.token_embedding.weight"] == (51865, 128)
    assert ranks[0]["shard_cached"] and ranks[1]["shard_cached"]
    for rank in (0, 1):  # each dp rank its row block; other values pass through
        got = ranks[rank]["shard_batch"]
        assert got["n"] == 6 and got["audio"].tolist() == np.arange(12).reshape(6, 2)[3 * rank : 3 * rank + 3].tolist()


def test_mesh_refuses_a_shape_that_is_not_the_world(served):
    refusals = served[0][0]["refusals"]
    assert "needs 4 ranks, but the world has 2" in refusals["(4, 1)"]
    assert "needs 3 ranks" in refusals["(3, 1)"]
    assert "tp 3 does not divide the world's 2 ranks" in refusals["(0, 3)"]


@pytest.mark.parametrize("name,shape,opts", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_batched_dp_matches_jax(served, name, shape, opts):
    """3 windows (a pad window at dp 2) through the port's mesh decode and
    JAX's at the same mesh shape; both ranks return the same results."""
    ranks, jax_out, _, _ = served
    assert ranks[0][name] == ranks[1][name]
    _compare_decodes(jax_out[name], ranks[0][name], I8_LP_TOL if opts.get("int8_encoder") else LP_TOL)


def test_sampled_rungs_draw_the_whole_batch_noise(served):
    """best_of 2 at t 0.7 over dp 2: the same samples as one process (the
    JAX package's samples come from another generator)."""
    ranks = served[0]
    assert ranks[0]["sampled"] == ranks[1]["sampled"]
    for (t, lp, ns, text), (t1, lp1, ns1, text1) in zip(ranks[0]["sampled"], ranks[0]["sampled_single"]):
        assert t == t1 and text == text1
        assert abs(lp - lp1) <= LP_TOL and abs(ns - ns1) <= LP_TOL


@pytest.mark.parametrize("name,shape,kw", BATCH_CASES, ids=[c[0] for c in BATCH_CASES])
def test_transcribe_batch_over_a_mesh_matches_jax(served, name, shape, kw):
    """Three inputs, four windows, in chunks of 2 windows: each dp rank
    decodes one window of a chunk. With kv_quant the log-probs are held
    within 1e-3: this model's peaked logits (the embedding scaled 8x) move
    by up to ~4e-4 where an fp32-level difference rounds a K/V value to the
    other int8 neighbour, on one device too."""
    ranks, jax_out, _, _ = served
    assert ranks[0][name] == ranks[1][name]
    if kw.get("kv_quant"):
        for j, t in zip(jax_out[name], ranks[0][name]):
            assert t["text"] == j["text"] and len(t["segments"]) == len(j["segments"])
            for a, b in zip(t["segments"], j["segments"]):
                assert (a["tokens"], a["start"], a["end"]) == (b["tokens"], b["start"], b["end"])
                assert abs(a["avg_logprob"] - b["avg_logprob"]) <= I8_LP_TOL
        return
    n_words = _compare_outputs(jax_out[name], ranks[0][name], words=kw.get("word_timestamps", False))
    if kw.get("word_timestamps"):
        assert n_words >= 3


@pytest.mark.parametrize("name", ["cli-dp", "cli-tp"])
def test_cli_dp_tp_write_what_jax_writes(served, name):
    """`--batch_mode True --dp 2` (and `--tp 2`: the doll's one head stays
    replicated, its MLP splits) writes, from rank 0 alone, the files JAX's
    CLI writes with `--dp 2`."""
    ranks, _, tmp, wavs = served
    assert ranks[1][name] == []
    assert len(ranks[0][name]) == 5 * len(wavs)
    for fname in ranks[0][name]:
        got = (tmp / f"{name}_rank0" / fname).read_bytes()
        want = (tmp / "jax_cli" / fname).read_bytes()
        if fname.endswith(".json"):
            import json

            _compare_outputs([json.loads(want)], [json.loads(got)])
        else:
            assert got == want, fname


def test_pad_rows_and_row_blocks():
    x = np.arange(10).reshape(5, 2)
    assert PM.pad_rows(x, 2).tolist()[-1] == [0, 0]
    assert PM.pad_rows(x, 2, repeat_last=True).tolist()[-1] == [8, 9]
    assert PM.pad_rows(torch.from_numpy(x), 4, repeat_last=True).shape == (8, 2)
    assert PM.pad_rows(x, 5) is x
