"""The port's fine-tune pieces against the JAX package: chunked CE, metrics,
dataset/collate, the 4-group AdamW, the `train_disease` twin, and the
entry points' default device."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_ttl_mtl_tpu.mtl import MultiTaskSpeechDataset as JDataset
from asr_ttl_mtl_tpu.mtl import TrainingConfig as JConfig
from asr_ttl_mtl_tpu.mtl import collate as jcollate
from asr_ttl_mtl_tpu.mtl import metrics as JM
from asr_ttl_mtl_tpu.mtl.dataset import audio_buckets as j_audio_buckets
from asr_ttl_mtl_tpu.mtl.fused_optim import fused_multigroup_adamw
from asr_ttl_mtl_tpu.ops.chunked_xent import chunked_softmax_xent as j_xent
from asr_ttl_mtl_tpu_torch import from_random, load_model, log_mel_spectrogram
from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig, collate
from asr_ttl_mtl_tpu_torch.mtl import metrics as PM
from asr_ttl_mtl_tpu_torch.mtl.dataset import audio_buckets
from asr_ttl_mtl_tpu_torch.mtl.fused_optim import MultiGroupAdamW, optimizer_hparams
from asr_ttl_mtl_tpu_torch.models import ModelDimensions
from asr_ttl_mtl_tpu_torch.ops.chunked_xent import chunked_softmax_xent

from torch_port_helpers import SMALL, TRAIN_CONFIG, WORDS, write_wav_dataset

# ------------------------------------------------------------ chunked CE ----


@pytest.mark.parametrize("row_chunk", [8, 512])
def test_chunked_xent_matches_jax(row_chunk):
    """fp32: loss and argmax, and the gradients with respect to hidden and
    the embedding under a weighted sum of the loss, to 1e-5 relative."""
    rng = np.random.RandomState(0)
    b, t, d, v = 3, 13, 32, 700
    hidden = rng.randn(b, t, d).astype(np.float32)
    embed = (rng.randn(v, d) * 0.3).astype(np.float32)
    targets = rng.randint(0, v, size=(b, t)).astype(np.int32)
    targets[:, 9:] = -100
    weights = rng.rand(b, t).astype(np.float32)

    def jloss(h, e):
        loss, _ = j_xent(h, e, jnp.asarray(targets), row_chunk=row_chunk)
        return jnp.sum(loss * weights)

    jl, jp = j_xent(jnp.asarray(hidden), jnp.asarray(embed), jnp.asarray(targets), row_chunk=row_chunk)
    jgh, jge = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(embed))

    h = torch.from_numpy(hidden).requires_grad_(True)
    e = torch.from_numpy(embed).requires_grad_(True)
    pl, pp = chunked_softmax_xent(h, e, torch.from_numpy(targets), row_chunk=row_chunk)
    (pl * torch.from_numpy(weights)).sum().backward()

    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert not pl.detach().numpy()[:, 9:].any()
    for got, want in ((h.grad, jgh), (e.grad, jge)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------- metrics ----


def _text_pairs(seed, n):
    rng = np.random.RandomState(seed)
    refs, hyps = [], []
    for _ in range(n):
        ref = list(rng.choice(WORDS, size=rng.randint(0, 9)))
        hyp = [w for w in ref if rng.rand() > 0.2] + list(rng.choice(WORDS, size=rng.randint(0, 3)))
        refs.append(" ".join(ref) + ("  " if rng.rand() < 0.2 else ""))
        hyps.append(" ".join(hyp).upper() if rng.rand() < 0.3 else " ".join(hyp))
    return refs, hyps


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (set(a) ^ set(b))
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-12, atol=1e-12)
    else:
        assert float(a) == pytest.approx(float(b), rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wer_cer_match_jax(seed):
    refs, hyps = _text_pairs(seed, 40)
    assert PM.wer(refs, hyps) == JM.wer(refs, hyps)
    assert PM.cer(refs, hyps) == JM.cer(refs, hyps)


@pytest.mark.parametrize("seed", [0, 1])
def test_detailed_metrics_match_jax(seed):
    refs, hyps = _text_pairs(seed + 10, 30)
    rng = np.random.RandomState(seed)
    labels = list(rng.randint(0, 3, size=30))
    preds = list(rng.randint(0, 3 if seed == 0 else 2, size=30))  # seed 1: a class never predicted
    _assert_same(PM.detailed_metrics(hyps, refs, preds, labels), JM.detailed_metrics(hyps, refs, preds, labels))
    np.testing.assert_array_equal(PM.confusion_matrix(labels, preds), JM.confusion_matrix(labels, preds))


# --------------------------------------------------------------- dataset ----


@pytest.mark.parametrize("model_size", ["tiny", "tiny.en"])
def test_collate_matches_jax(tmp_path, model_size):
    """Items and collated arrays of the same CSV, a missing file included,
    identical on both sides (token layout, -100/EOT padding, buckets)."""
    csv_path = write_wav_dataset(tmp_path, n=7, seed=3, missing=(2,))
    kw = {**TRAIN_CONFIG, "model_size": model_size}
    jds = JDataset(csv_path, JConfig(**kw))
    pds = MultiTaskSpeechDataset(csv_path, TrainingConfig(**kw))
    assert len(pds) == len(jds) == 7
    for idxs in ([0, 1, 2, 3], [4, 5, 6]):
        jitems = [jds[i] for i in idxs]
        pitems = [pds[i] for i in idxs]
        for a, b in zip(pitems, jitems):
            assert a["input_tokens"] == b["input_tokens"] and a["target_tokens"] == b["target_tokens"]
        jb = jcollate(jitems, jds.tokenizer, kw["token_buckets"], j_audio_buckets(jds.config))
        pb = collate(pitems, pds.tokenizer, kw["token_buckets"], audio_buckets(pds.config))
        for key in ("audio", "input_tokens", "target_tokens", "classes"):
            assert pb[key].dtype == jb[key].dtype and pb[key].shape == jb[key].shape, key
            np.testing.assert_array_equal(pb[key], jb[key], err_msg=key)
        assert pb["texts"] == jb["texts"]
    assert not pds[2]["audio"].any() and len(pds[2]["audio"]) == 1  # the missing file: zero audio
    assert pds[0]["input_tokens"][2 if model_size == "tiny" else 1] in pds.tokenizer.disease_tokens.values()


def test_loader_order_and_drop_last(tmp_path):
    csv_path = write_wav_dataset(tmp_path, n=10, seed=4)
    cfg = TrainingConfig(**TRAIN_CONFIG)
    ds = MultiTaskSpeechDataset(csv_path, cfg)
    loader = DataLoader(ds, 4, shuffle=True, num_workers=2, drop_last=True, seed=5, buckets=(48, 96))
    order = np.arange(10)
    np.random.RandomState(5).shuffle(order)
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    assert [p for b in batches for p in b["paths"]] == [ds.rows[i]["file"] for i in order[:8]]
    second = list(loader)  # the next epoch reshuffles with seed + 1
    order2 = np.arange(10)
    np.random.RandomState(6).shuffle(order2)
    assert [p for b in second for p in b["paths"]] == [ds.rows[i]["file"] for i in order2[:8]]


# --------------------------------------------------------- 4-group AdamW ----


def _opt_inputs(seed):
    rng = np.random.RandomState(seed)
    shapes = {
        ("model", "encoder", "w"): (5, 7), ("model", "encoder", "b"): (7,),
        ("model", "decoder", "token_embedding"): (11, 4), ("model", "decoder", "w"): (4, 9),
        ("classifier", "fc1", "w"): (3, 130), ("classifier", "fc1", "b"): (130,),
    }
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    # step 1 clips (norm > 1), steps 2-3 do not
    grads = [{k: (rng.randn(*s) * (3.0 if i == 0 else 0.01)).astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]
    return params, grads


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return out


def _label(path):
    if path[0] == "classifier":
        return "classifier"
    if path[1] == "encoder":
        return "encoder"
    return "embeddings" if path[2] == "token_embedding" else "decoder"


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_fused_multigroup_adamw(moment_dtype):
    """Params and moments after 3 steps, to 1e-6 relative (and, for the
    moments, 1e-6 of each buffer's largest value)."""
    params, grads = _opt_inputs(0)
    hp = optimizer_hparams(1e-2, 0.01)
    labels = _nest({k: _label(k) for k in params})
    jopt = fused_multigroup_adamw(labels, hp, 1.0, moment_dtype=jnp.dtype(moment_dtype))
    jparams = jax.tree.map(jnp.asarray, _nest(params))
    jstate = jopt.init(jparams)
    for g in grads:
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, _nest(g)), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)

    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)  # the JAX leaf order
    paths = [tuple(str(getattr(k, "key", k)) for k in p) for p, _ in leaves]
    tp = {k: torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in paths}
    groups = {}
    for k in paths:
        groups.setdefault(_label(k), []).append(tp[k])
    popt = MultiGroupAdamW(groups, hp, 1.0, moment_dtype=getattr(torch, moment_dtype))
    for g in grads:
        for k in paths:
            tp[k].grad = torch.from_numpy(g[k])
        popt.step()

    for (path, leaf), k in zip(leaves, paths):
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(leaf), rtol=1e-6, atol=1e-7, err_msg=str(k))
    for name in ("m", "v"):
        for group, bufs in getattr(popt, name).items():
            flat = [np.pad(b.float().numpy().ravel(), (0, -b.numel() % 128)) for b in bufs]
            want = np.asarray(getattr(jstate, name)[f"{group}:float32"], np.float32).ravel()
            # 1e-6 of the buffer's scale: where (1-b1) g and b1 m nearly cancel,
            # an ulp of either side is a larger share of the difference
            np.testing.assert_allclose(np.concatenate(flat), want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{name} {group}")
    assert popt.count == int(jstate.count) == 3


# --------------------------------------------------------- trainer options --


@pytest.mark.parametrize("option", [dict(chunked_ce=False), dict(remat=True), dict(freeze_encoder=True)],
                         ids=["materialized-logits", "remat", "freeze-encoder"])
def test_trainer_options_keep_the_step(tmp_path, option):
    """From the same seeded weights, materialized training logits and remat
    give the default step's loss and gradients (fp32, 1e-5); freeze_encoder
    gives its loss and decoder update and leaves the encoder as it was."""
    cfg = {**TRAIN_CONFIG, "device": "cpu"}
    ds = MultiTaskSpeechDataset(write_wav_dataset(tmp_path, n=4, seed=8), TrainingConfig(**cfg))
    batch = collate([ds[i] for i in range(4)], ds.tokenizer, cfg["token_buckets"], audio_buckets(ds.config))
    keep = torch.from_numpy(np.random.RandomState(0).rand(4, 64) < 0.9)
    base = MultiTaskTrainer(TrainingConfig(**cfg), verbose=False)
    other = MultiTaskTrainer(TrainingConfig(**{**cfg, **option}), verbose=False)
    enc_before = {n: p.detach().clone() for n, p in other.model.encoder.named_parameters()}
    base_loss, _ = base.train_step(batch, keep=keep)
    other_loss, _ = other.train_step(batch, keep=keep)
    assert float(other_loss) == pytest.approx(float(base_loss), rel=1e-5)
    pairs = list(zip(base.named_trainable(), other.named_trainable()))
    if option.get("freeze_encoder"):
        for n, p in other.model.encoder.named_parameters():
            assert torch.equal(p, enc_before[n]), n
        for (name, a), (_, b) in pairs:
            if not name.startswith("model.encoder."):
                torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=name)
    else:
        for (name, a), (_, b) in pairs:
            torch.testing.assert_close(b.grad, a.grad, rtol=1e-5, atol=1e-5 * a.grad.abs().max().item(), msg=name)


# ------------------------------------------------------ train_disease twin --


def test_train_disease_twin_runs_one_epoch_on_cpu(tmp_path):
    from asr_ttl_mtl_tpu_torch.scripts import train_disease

    train_csv = write_wav_dataset(tmp_path, n=8, seed=1)
    val_csv = write_wav_dataset(tmp_path, n=4, seed=2)
    out = tmp_path / "out"
    train_disease.main([
        "--model_size", "tiny", "--epochs", "1", "--batch_size", "4", "--val_batch_size", "4",
        "--pretrained", "random", "--train_csv", train_csv, "--val_csv", val_csv, "--test_csv", val_csv,
        "--save_dir", str(out), "--compute_dtype", "float32", "--num_workers", "2", "--device", "cpu",
        "--debug_dims", json.dumps(TRAIN_CONFIG["debug_dims"]), "--audio_samples", "20480",
    ])
    for name in ("best_multitask_model_tiny.pt", "training_config_tiny.json", "training_history_tiny.json"):
        assert os.path.exists(out / name), name
    history = json.loads((out / "training_history_tiny.json").read_text())
    assert len(history) == 1 and np.isfinite(history[0]["train_metrics"]["loss"])
    ckpt = torch.load(out / "best_multitask_model_tiny.pt", map_location="cpu", weights_only=False)
    assert ckpt["model_state_dict"]["decoder.token_embedding.weight"].shape[0] == 51869
    assert set(ckpt["disease_classifier_state_dict"]) == {"0.weight", "0.bias", "3.weight", "3.bias"}


def test_train_disease_twin_refuses_what_the_port_does_not_serve(tmp_path):
    from asr_ttl_mtl_tpu_torch.scripts import train_disease

    csv_path = write_wav_dataset(tmp_path, n=4, seed=1)
    base = ["--pretrained", "random", "--train_csv", csv_path, "--val_csv", csv_path, "--device", "cpu",
            "--save_dir", str(tmp_path / "out"), "--debug_dims", json.dumps(TRAIN_CONFIG["debug_dims"]),
            "--audio_samples", "20480", "--compute_dtype", "float32"]
    import torch.distributed as dist

    try:
        for extra, error in ((["--dp", "2", "--zero1"], ValueError), (["--steps_per_call", "4"], NotImplementedError),
                             (["--tp", "2"], ValueError), (["--packed_dispatch", "True"], NotImplementedError)):
            with pytest.raises(error):  # a mesh larger than the world of 1 rank; what the port does not serve
                train_disease.main(base + extra)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------- entry points run on the card ---


def test_entry_points_default_to_the_card(tmp_path):
    """from_random, load_model and log_mel_spectrogram run on the card
    unless given device="cpu"; without a card they raise instead of running
    on the CPU."""
    dims = ModelDimensions(**SMALL)
    cpu_model = from_random(dims, device="cpu")
    path = str(tmp_path / "m.pt")
    torch.save({"dims": dims.__dict__, "model_state_dict": cpu_model.state_dict()}, path)
    audio = np.zeros(16000, np.float32)
    calls = (lambda: from_random(dims), lambda: load_model(path), lambda: log_mel_spectrogram(audio))
    if torch.cuda.is_available():
        assert from_random(dims).device.type == "cuda"
        assert load_model(path).device.type == "cuda"
        assert log_mel_spectrogram(audio).device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert cpu_model.device.type == "cpu"
    assert load_model(path, device="cpu").device.type == "cpu"
    assert log_mel_spectrogram(audio, device="cpu").device.type == "cpu"
    # a tensor stays on its own device
    assert log_mel_spectrogram(torch.zeros(16000)).device.type == "cpu"
