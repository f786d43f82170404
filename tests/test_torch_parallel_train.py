"""The multi-device trainer: `mesh_shape` (2, 1) through each
`dp_shard_map` setting, (2, 1) with `zero1` and (1, 2), on 2 ranks over
gloo, against the JAX trainer at the same mesh shapes on the 8 virtual
devices of tests/conftest.py (mirroring tests/test_dp_shard_map.py:102-230,
tests/test_parallel.py:134 and tests/test_parallel_hardening.py:26-75):
losses, alpha and beta, gradient norms per optimizer group and weights
after each step, and `evaluate`; then a padded batch, and a resume state
written at world size 2 and read at 1.

The ranks are spawned once for the module and run
tests/torch_parallel_workers.py while the JAX trainers run here; 2+2
layers, d 128, 2 heads, fp32, batches of 4 (tests/test_torch_trainer.py's
set-up). Tolerances: losses, alpha/beta, gradient norms and evaluation
losses within 1e-4 relative (fp32 both sides, sums in another order);
weights within 2 lr a step (the most a sign flip of an AdamW step moves a
weight).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.mtl import MultiTaskTrainer as JTrainer
from asr_ttl_mtl_tpu.mtl import TrainingConfig as JConfig
from asr_ttl_mtl_tpu_torch.models import state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
from asr_ttl_mtl_tpu_torch.mtl.trainer import classifier_state_from_jax
from asr_ttl_mtl_tpu_torch.parallel.launch import run_ranks

from test_torch_trainer import REL, _batches, _jax_grad_fn, _jax_step
from torch_parallel_workers import train_cases
from torch_port_helpers import TRAIN_CONFIG, np_tree, write_wav_dataset

STEPS = 2
BOUND = 2 * TRAIN_CONFIG["learning_rate"]  # per step
PORT_CONFIG = {k: v for k, v in TRAIN_CONFIG.items() if k != "mesh_shape"}
JAX_MESHES = {  # JAX trainer -> its TrainingConfig overrides
    "dp": dict(mesh_shape=(2, 1), dp_shard_map=True),
    "dp-pjit": dict(mesh_shape=(2, 1), dp_shard_map=False),
    "dp-zero1": dict(mesh_shape=(2, 1), dp_shard_map=True, zero1=True),
    "tp": dict(mesh_shape=(1, 2)),
}
PORT_CASES = {  # port case -> (its TrainingConfig overrides, the JAX trainers it is held against)
    "dp": (dict(mesh_shape=(2, 1)), ("dp", "dp-pjit")),
    "dp-pjit": (dict(mesh_shape=(2, 1), dp_shard_map=False), ("dp", "dp-pjit")),
    "dp-force": (dict(mesh_shape=(0, 1), dp_shard_map="force"), ("dp", "dp-pjit")),
    "dp-zero1": (dict(mesh_shape=(2, 1), zero1=True), ("dp-zero1",)),
    "tp": (dict(mesh_shape=(1, 2)), ("tp",)),
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    train = _batches(tmp, seed=12, n_batches=STEPS)
    (val,) = _batches(tmp, seed=11, n_batches=1)
    odd = _batches(tmp, seed=15, n_batches=2)
    odd = [{k: (v[:3] if k in ("audio", "input_tokens", "target_tokens", "classes", "texts", "paths") else v)
            for k, v in b.items()} for b in odd]  # 3 rows: dp 2 pads one
    jtrs = {name: JTrainer(JConfig(**{**TRAIN_CONFIG, **kw}, save_dir=str(tmp / f"jax_{name}")), verbose=False)
            for name, kw in JAX_MESHES.items()}
    ref = jtrs["dp"]
    model_state = state_dict_from_jax_params(np_tree(ref.model.params), ref.model.dims)
    classifier_state = classifier_state_from_jax(np_tree(ref.classifier_params))

    # the keep-masks each JAX step draws (every JAX trainer's key starts from the seed)
    probe = JTrainer(JConfig(**TRAIN_CONFIG), verbose=False)
    import jax

    keeps = []
    for batch in train:
        probe._rng, sub = jax.random.split(probe._rng)
        keeps.append(np.asarray(jax.random.bernoulli(sub, 0.9, (len(batch["classes"]), 64))))
    odd_keeps = [np.random.RandomState(i).rand(3, 64) < 0.9 for i in range(len(odd))]

    cases = [dict(name=name, kw=kw, batches=train, keeps=keeps, val=[val]) for name, (kw, _) in PORT_CASES.items()]
    cases.append(dict(name="dp-odd", kw=dict(mesh_shape=(2, 1)), batches=odd, keeps=odd_keeps, val=[]))
    resume = dict(kw=dict(mesh_shape=(2, 1), zero1=True), train=train, val=[val], dir=str(tmp / "resume"))
    csv_path = write_wav_dataset(tmp, n=4, seed=1)
    script = ["--pretrained", "random", "--train_csv", csv_path, "--val_csv", csv_path, "--device", "cpu",
              "--debug_dims", json.dumps(TRAIN_CONFIG["debug_dims"]), "--audio_samples", "20480",
              "--compute_dtype", "float32", "--epochs", "1", "--batch_size", "4", "--num_workers", "1",
              "--dp", "2", "--zero1"]
    payload = dict(config=PORT_CONFIG, model_state=model_state, classifier_state=classifier_state, cases=cases,
                   root=str(tmp), resume=resume, script=script)
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(train_cases, 2, payload, store_dir=str(tmp), timeout=900)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test thread below
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_out = {}
        for name, jtr in jtrs.items():
            grad_fn = _jax_grad_fn(jtr) if name in ("dp", "tp") else None
            steps = []
            for batch, keep in zip(train, keeps):
                loss, aux, jkeep, norms = _jax_step(jtr, batch, grad_fn)
                assert np.array_equal(jkeep, keep)
                steps.append(dict(loss=loss, cls_loss=float(aux["cls_loss"]), trans_loss=float(aux["trans_loss"]),
                                  alpha=jtr.alpha, beta=jtr.beta, norms=norms))
            metrics = jtr.evaluate([val]) if name == "dp" else None
            jax_out[name] = dict(steps=steps, metrics=metrics,
                                 model=state_dict_from_jax_params(np_tree(jtr.model.params), jtr.model.dims),
                                 classifier=classifier_state_from_jax(np_tree(jtr.classifier_params)))
        # the single-device port on the padded batches, and the run the resumed one is held against
        single = MultiTaskTrainer(TrainingConfig(**PORT_CONFIG, device="cpu"), verbose=False)
        single.load_state(model_state, classifier_state)
        odd_single = [single.train_step(b, keep=torch.from_numpy(k)) for b, k in zip(odd, odd_keeps)]
        whole = MultiTaskTrainer(TrainingConfig(**{**PORT_CONFIG, "epochs": 2}, device="cpu",
                                                save_dir=str(tmp / "whole")), verbose=False)
        whole.load_state(model_state, classifier_state)
        whole_history = whole.train(train, [val])["training_history"]
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return dict(ranks=ranks["out"], jax=jax_out, odd_single=odd_single, whole=whole, whole_history=whole_history,
                model_state=model_state, classifier_state=classifier_state, train=train, val=val, tmp=tmp)


def _close(got, want, rel=REL):
    return got == pytest.approx(want, rel=rel)


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_train_steps_match_jax(trained, case):
    """Every step's losses and frozen alpha/beta, the gradient norms per
    group (where the JAX step's gradient is taken) and the weights after
    each run, against each JAX route the case is held to; both ranks end
    with the same weights."""
    ranks, jax_out = trained["ranks"], trained["jax"]
    got = ranks[0][case]
    for key in got["model"]:
        np.testing.assert_array_equal(got["model"][key], ranks[1][case]["model"][key], err_msg=key)
    for jname in PORT_CASES[case][1]:
        want = jax_out[jname]
        for step, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            for key in ("loss", "cls_loss", "trans_loss", "alpha", "beta"):
                assert _close(g[key], w[key]), (jname, step, key)
            if w["norms"] is not None:
                assert set(g["norms"]) == set(w["norms"])
                for group in w["norms"]:
                    assert _close(g["norms"][group], w["norms"][group]), (jname, step, group)
        worst = max(np.abs(got["model"][k] - want["model"][k].numpy()).max() for k in want["model"])
        worst = max(worst, max(np.abs(got["classifier"][k] - want["classifier"][k].numpy()).max()
                               for k in want["classifier"]))
        assert worst <= BOUND * STEPS, (jname, worst)


def test_routes_and_zero1_agree_bit_for_bit(trained):
    """The three dp_shard_map settings are one route; ZeRO-1 changes where
    the moments live, not a bit of the weights; its moments come back whole."""
    ranks = trained["ranks"][0]
    assert ranks["dp"]["mesh"] == ranks["dp-force"]["mesh"] == {"dp": 2, "tp": 1}
    assert ranks["tp"]["mesh"] == {"dp": 1, "tp": 2}
    assert ranks["dp-zero1"]["zero1"] and not ranks["dp"]["zero1"]
    for other in ("dp-pjit", "dp-force", "dp-zero1"):
        for key, value in ranks["dp"]["model"].items():
            np.testing.assert_array_equal(ranks[other]["model"][key], value, err_msg=(other, key))
    for g, ms in ranks["dp"]["opt_m"].items():
        for a, b in zip(ms, ranks["dp-zero1"]["opt_m"][g]):
            np.testing.assert_array_equal(a, b)
    assert ranks["dp-zero1"]["opt_count"] == STEPS


def test_tp_moments_come_back_whole(trained):
    ranks = trained["ranks"][0]
    single = MultiTaskTrainer(TrainingConfig(**PORT_CONFIG, device="cpu"), verbose=False)
    shapes = {g: [tuple(p.shape) for p in ps] for g, ps in single.optimizer.groups.items()}
    assert {g: [x.shape for x in xs] for g, xs in ranks["tp"]["opt_m"].items()} == {
        g: s for g, s in shapes.items() if g != "frozen"}


def test_dp_evaluate_matches_jax(trained):
    got, want = trained["ranks"][0]["dp"]["metrics"], trained["jax"]["dp"]["metrics"]
    assert trained["ranks"][1]["dp"]["metrics"] == got
    for key in ("loss", "cls_loss", "trans_loss"):
        assert _close(got[key], want[key]), key
    for key in ("wer", "cer", "disease_acc", "macro_f1"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key


def test_padded_batch_matches_one_device(trained):
    """Batches of 3 rows over dp 2 (a copy of the last row pads rank 1's
    block and weighs nothing): the single-device port's losses, and the
    whole batch's per-row outputs on both ranks."""
    got = trained["ranks"][0]["dp-odd"]["steps"]
    for g, (loss, aux) in zip(got, trained["odd_single"]):
        assert _close(g["loss"], float(loss))
        assert _close(g["cls_loss"], float(aux["cls_loss"])) and _close(g["trans_loss"], float(aux["trans_loss"]))
        np.testing.assert_array_equal(g["pred_tokens"], aux["pred_tokens"].numpy())
        np.testing.assert_array_equal(g["disease_preds"], aux["disease_preds"].numpy())
    assert all(s["pred_tokens"].shape[0] == 3 for s in got)


def test_resume_across_world_sizes(trained):
    """An epoch at dp 2 with ZeRO-1 writes its resume state (rank 0, whole
    moments); a one-device trainer resumes from it for the second epoch and
    matches a one-device 2-epoch run from the same weights."""
    tmp = trained["tmp"]
    resume_dir = str(tmp / "resume")
    assert sorted(os.listdir(resume_dir)) == ["meta.json", "state.pt"]
    resumed = MultiTaskTrainer(TrainingConfig(**{**PORT_CONFIG, "epochs": 2}, device="cpu",
                                              save_dir=str(tmp / "resumed")), verbose=False)
    resumed.load_state(trained["model_state"], trained["classifier_state"])
    history = resumed.train(trained["train"], [trained["val"]], resume_dir=resume_dir)["training_history"]
    assert resumed.optimizer.count == 2 * STEPS and len(history) == 2
    want = trained["whole_history"]
    for epoch in range(2):
        for part in ("train_metrics", "val_metrics"):
            for key in ("loss", "cls_loss", "trans_loss"):
                assert _close(history[epoch][part][key], want[epoch][part][key]), (epoch, part, key)
    whole = trained["whole"].full_model_state()
    worst = max((resumed.full_model_state()[k] - v).abs().max().item() for k, v in whole.items())
    assert worst <= BOUND * 2 * STEPS


def test_train_disease_script_over_dp_zero1(trained):
    """`--dp 2 --zero1` through the training twin: rank 0 writes the
    checkpoint, the history and the config; rank 1 writes nothing."""
    ranks = trained["ranks"]
    assert ranks[0]["script"] == ["best_multitask_model_tiny.pt", "training_config_tiny.json",
                                  "training_history_tiny.json"]
    assert ranks[1]["script"] == []


def test_trainer_refuses_a_mesh_larger_than_the_world():
    import torch.distributed as dist

    try:
        with pytest.raises(ValueError, match="needs 2 ranks, but the world has 1"):
            MultiTaskTrainer(TrainingConfig(**PORT_CONFIG, mesh_shape=(2, 1), device="cpu"), verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
