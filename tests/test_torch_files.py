"""Files in, reports out, at the training tests' size (2+2 layers, d=128,
fp32, CPU): the loader's native batch decode and its `mel_fp16` producer
against the JAX package's loader, the inference and evaluate twins (their
report code fed the same results as the top-level JAX script, then each
twin end to end on a 4-clip CSV), `resume_dir` (interrupted and resumed
against uninterrupted, bit for bit) and `profile_dir`."""

import csv
import importlib.util
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.mtl import DataLoader as JLoader
from asr_ttl_mtl_tpu.mtl import MultiTaskSpeechDataset as JDataset
from asr_ttl_mtl_tpu.mtl import TrainingConfig as JConfig

from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig
from asr_ttl_mtl_tpu_torch.runtime import wav as pwav
from asr_ttl_mtl_tpu_torch.scripts import evaluate_disease, inference_disease

from test_torch_native import fp16_steps
from torch_port_helpers import TRAIN_CONFIG, write_wav_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_CONFIG = {**TRAIN_CONFIG, "device": "cpu"}


def _jax_script(name):
    """The top-level JAX script `scripts/<name>.py`, imported as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- the loader -----------------------------------------------------------


@pytest.mark.parametrize("transfer", ["int16", "mel_fp16"])
def test_loader_batches_as_jax(tmp_path, capsys, transfer):
    """One native `load_batch` per batch of WAVs: the same waveforms (or
    fp16 mels, within one fp16 step) and tokens as the JAX loader, a zero
    row and the JAX error line for a missing file."""
    csv_path = write_wav_dataset(tmp_path, n=6, seed=5, missing=(3,))
    cfg = {**TRAIN_CONFIG, "audio_transfer_dtype": transfer}
    ploader = DataLoader(MultiTaskSpeechDataset(csv_path, TrainingConfig(**cfg)), 3, num_workers=2,
                         buckets=cfg["token_buckets"])
    jloader = JLoader(JDataset(csv_path, JConfig(**cfg)), 3, num_workers=2, buckets=cfg["token_buckets"])
    before = pwav.CALLS["load_batch"]
    pbatches = list(ploader)
    assert pwav.CALLS["load_batch"] == before + 2
    printed = capsys.readouterr().out
    assert f"Error loading audio {tmp_path}/clip5_3.wav: native decode -1" in printed
    for pb, jb in zip(pbatches, list(jloader), strict=True):
        for key in ("input_tokens", "target_tokens", "classes"):
            np.testing.assert_array_equal(pb[key], jb[key])
        assert pb["texts"] == jb["texts"] and pb["paths"] == jb["paths"]
        if transfer == "int16":
            np.testing.assert_array_equal(pb["audio"], jb["audio"])
        else:
            assert pb["audio"].dtype == jb["audio"].dtype == np.float16 and pb["audio"].shape == jb["audio"].shape
            assert fp16_steps(pb["audio"], jb["audio"]) <= 1.0
    if transfer == "int16":
        assert not pbatches[1]["audio"][0].any()  # the missing file's row


def test_loader_takes_the_item_path_for_other_files(tmp_path, capsys):
    """A batch with a file that is not a `.wav` decodes item by item through
    `load_audio` (ffmpeg, absent here: an error line and zero audio)."""
    csv_path = write_wav_dataset(tmp_path, n=3, seed=6)
    with open(csv_path) as f:
        rows = f.read().splitlines()
    rows[2] = rows[2].replace(".wav,", ".flac,", 1)
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    loader = DataLoader(MultiTaskSpeechDataset(csv_path, TrainingConfig(**TRAIN_CONFIG)), 3, num_workers=2,
                        buckets=TRAIN_CONFIG["token_buckets"])
    before = pwav.CALLS["load_batch"]
    os.environ["PATH"], path = "", os.environ["PATH"]
    try:
        (batch,) = list(loader)
    finally:
        os.environ["PATH"] = path
    assert pwav.CALLS["load_batch"] == before
    assert "Error loading audio" in capsys.readouterr().out and not batch["audio"][1].any()
    assert batch["audio"][0].any() and batch["audio"][2].any()


# --- the twins --------------------------------------------------------------


def _results(seed=0, n=7):
    """A run_inference result of n seeded samples."""
    rng = np.random.RandomState(seed)
    names = {0: "normal", 1: "dysphonia", 2: "dysarthria"}
    data = []
    for i in range(n):
        t, p = int(rng.randint(3)), int(rng.randint(3))
        probs = rng.dirichlet(np.ones(3))
        data.append({
            "file_path": f"/data/clip,{i}.wav" if i == 2 else f"/data/clip{i}.wav",
            "original_text": "hello there, friend" if i % 2 else "fine",
            "predicted_text": "hello friend" if i % 3 else "",
            "original_text_normalized": "x", "predicted_text_normalized": "y",
            "wer": float(rng.rand()), "cer": float(rng.rand() / 3), "true_disease": names[t],
            "predicted_disease": names[p], "true_class": t, "predicted_class": p,
            "disease_confidence": float(probs[p]), "disease_correct": t == p,
            "all_disease_probs": {names[c]: float(probs[c]) for c in range(3)},
        })
    per_class = {d: {"samples": 2, "accuracy": 0.5, "wer": 0.25, "cer": 0.125} for d in names.values()}
    return {"total_samples": n, "overall_wer": 0.4, "overall_cer": 0.2, "disease_accuracy": 3 / 7,
            "disease_correct": 3, "per_class_metrics": per_class, "inference_results": data,
            "model_info": {"class_to_disease": names, "model_size": "tiny", "is_english_only": False}}


@pytest.mark.parametrize("seed", [0, 1])
def test_report_code_as_the_jax_script(tmp_path, seed):
    """The same results through the port's and the JAX script's
    `calculate_additional_metrics`, `print_results` and `save_results`:
    equal metrics, printed report, CSV rows and summary JSON (bar the
    timestamp)."""
    jscript = _jax_script("inference_disease")
    results = _results(seed)
    extra, jextra = inference_disease.calculate_additional_metrics(results), jscript.calculate_additional_metrics(results)
    assert extra == jextra
    printed = []
    for module, ex in ((inference_disease, extra), (jscript, jextra)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            module.print_results(results, ex)
        printed.append(buf.getvalue())
    assert printed[0] == printed[1]
    saved = []
    for module, where in ((inference_disease, "port"), (jscript, "jax")):
        os.makedirs(tmp_path / where)
        with redirect_stdout(io.StringIO()):
            module.save_results(results, extra, str(tmp_path / where / "results.csv"))
        files = sorted(os.listdir(tmp_path / where))
        assert len(files) == 2 and files[1].endswith("_summary.json")
        with open(tmp_path / where / files[0], newline="") as f:
            rows = list(csv.reader(f))
        with open(tmp_path / where / files[1]) as f:
            summary = json.load(f)
        summary.pop("timestamp")
        saved.append((rows, summary))
    assert saved[0] == saved[1]
    assert len(saved[0][0]) == len(results["inference_results"]) + 1


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2+2-layer d=128 checkpoint from one train step and a 4-clip val CSV."""
    d = tmp_path_factory.mktemp("twins")
    cfg = TrainingConfig(**CPU_CONFIG, save_dir=str(d))
    trainer = MultiTaskTrainer(cfg, verbose=False)
    ds = MultiTaskSpeechDataset(write_wav_dataset(d, n=4, seed=21), cfg)
    (batch,) = list(DataLoader(ds, 4, num_workers=2, buckets=cfg.token_buckets))
    trainer.train_step(batch)
    trainer.save_checkpoint(epoch=0, best_loss=1.0)
    return trainer.checkpoint_path(), write_wav_dataset(d, n=4, seed=22), d


def test_inference_twin_end_to_end(trained, capsys):
    ckpt, val_csv, d = trained
    results, extra = inference_disease.main(["--model_path", ckpt, "--test_csv", val_csv, "--batch_size", "4",
                                             "--device", "cpu", "--save_results", str(d / "results.csv")])
    printed = capsys.readouterr().out
    assert "INFERENCE RESULTS" in printed and "Confusion Matrix:" in printed
    assert results["total_samples"] == 4 and all(np.isfinite(r["wer"]) for r in results["inference_results"])
    assert all(np.isfinite(v) for k, v in extra.items() if not k.startswith("per_class"))
    files = sorted(f for f in os.listdir(d) if f.startswith("results_"))
    assert len(files) == 2 and files[0].endswith(".csv") and files[1].endswith("_summary.json")
    # the same numbers as the trainer's own evaluation of those clips
    trainer = MultiTaskTrainer.load_from_checkpoint(ckpt, verbose=False, device="cpu")
    loader = DataLoader(MultiTaskSpeechDataset(val_csv, trainer.config), 4, num_workers=2)
    metrics = trainer.evaluate(loader)
    assert results["disease_accuracy"] == metrics["disease_acc"]
    data = results["inference_results"]
    from asr_ttl_mtl_tpu_torch.mtl import metrics as M

    assert M.wer([r["original_text_normalized"] for r in data],
                 [r["predicted_text_normalized"] for r in data]) == metrics["wer"]


def test_evaluate_twin_end_to_end(trained, capsys):
    ckpt, val_csv, d = trained
    report = str(d / "report.json")
    metrics = evaluate_disease.main(["--model_path", ckpt, "--csv", val_csv, "--batch_size", "4",
                                     "--device", "cpu", "--output_json", report])
    assert "EVALUATION REPORT" in capsys.readouterr().out
    with open(report) as f:
        saved = json.load(f)
    for key in ("loss", "cls_loss", "trans_loss", "wer", "cer", "disease_acc", "macro_f1"):
        assert np.isfinite(saved[key]) and saved[key] == pytest.approx(metrics[key]), key


# --- resume_dir and profile_dir ----------------------------------------------


def _run(directory, csv_path, epochs, resume_dir=None, **kw):
    cfg = TrainingConfig(**{**CPU_CONFIG, "epochs": epochs, "save_dir": str(directory), **kw})
    trainer = MultiTaskTrainer(cfg, verbose=False)
    ds = MultiTaskSpeechDataset(csv_path, cfg)
    train = DataLoader(ds, 4, shuffle=True, num_workers=2, drop_last=True, seed=0, buckets=cfg.token_buckets)
    val = DataLoader(ds, 6, num_workers=2, buckets=cfg.token_buckets)
    return trainer, trainer.train(train, val, resume_dir=resume_dir)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """1 epoch, then a new trainer resumed from the directory for the 2nd:
    the weights, the optimizer's moments and the history equal, bit for bit,
    those of one 2-epoch run from the same seed (dynamic alpha/beta, frozen
    after the first batch; dropout from the trainer's generator; shuffled
    batches). On one thread: the CPU's multithreaded GEMM sums the tied
    embedding's gradient in an order that can change from one run to the
    next, even in one process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_resume(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _check_resume(tmp_path):
    csv_path = write_wav_dataset(tmp_path, n=6, seed=31)  # one shuffled step of 4 an epoch
    whole, whole_out = _run(tmp_path / "whole", csv_path, 2)
    resume = str(tmp_path / "resume")
    _run(tmp_path / "first", csv_path, 1, resume_dir=resume)
    with open(os.path.join(resume, "meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 0 and len(meta["training_history"]) == 1 and 0 < meta["alpha"] < 1
    resumed, resumed_out = _run(tmp_path / "second", csv_path, 2, resume_dir=resume)
    for a, b in zip(whole.named_trainable(), resumed.named_trainable(), strict=True):
        assert torch.equal(a[1], b[1]), a[0]
    assert whole.optimizer.count == resumed.optimizer.count == 2
    for g in whole.optimizer.m:
        for x, y in zip(whole.optimizer.m[g] + whole.optimizer.v[g], resumed.optimizer.m[g] + resumed.optimizer.v[g]):
            assert torch.equal(x, y), g
    assert (whole.alpha, whole.beta) == (resumed.alpha, resumed.beta)
    assert whole_out["best_loss"] == resumed_out["best_loss"]
    assert [h["train_metrics"]["loss"] for h in whole_out["training_history"]] == \
        [h["train_metrics"]["loss"] for h in resumed_out["training_history"]]


def test_profile_dir_writes_a_trace_and_the_timer(tmp_path, capsys):
    csv_path = write_wav_dataset(tmp_path, n=8, seed=41)
    cfg = TrainingConfig(**{**CPU_CONFIG, "profile_dir": str(tmp_path / "prof")})
    trainer = MultiTaskTrainer(cfg, verbose=True)
    loader = DataLoader(MultiTaskSpeechDataset(csv_path, cfg), 4, num_workers=2, buckets=cfg.token_buckets)
    trainer.train_epoch(loader, 0)
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "prof" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    assert "  profile: mean step" in capsys.readouterr().out
    trainer.train_epoch(DataLoader(loader.dataset, 4, drop_last=True, buckets=cfg.token_buckets), 1)
    assert len(os.listdir(tmp_path / "prof")) == 1  # only epoch 0 is traced
