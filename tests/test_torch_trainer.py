"""The training slice as a whole: the port's MultiTaskTrainer against the
JAX package's, from the same carried weights, on the same batches and the
same dropout keep-masks (drawn with jax.random.bernoulli from the key the
JAX step gets), at 2+2 layers, d=128, fp32, batch 4, chunked CE on. The
JAX trainer runs its einsum attention on the CPU; the port's plain
versions of the kernels have their own interpret-mode tests
(test_torch_flash_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.mtl import MultiTaskTrainer as JTrainer
from asr_ttl_mtl_tpu.mtl import TrainingConfig as JConfig
from asr_ttl_mtl_tpu.mtl import collate as jcollate
from asr_ttl_mtl_tpu.mtl import MultiTaskSpeechDataset as JDataset
from asr_ttl_mtl_tpu.mtl.dataset import audio_buckets
from asr_ttl_mtl_tpu_torch.models import state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of
from asr_ttl_mtl_tpu_torch.mtl.trainer import classifier_state_from_jax

from torch_port_helpers import TRAIN_CONFIG, np_tree, write_wav_dataset

REL = 1e-4  # losses, alpha/beta and grad norms: fp32 both sides, sums in another order
STEPS = 3


def _batches(directory, seed, n_batches):
    csv_path = write_wav_dataset(directory, n=4 * n_batches, seed=seed, missing=(1,))
    ds = JDataset(csv_path, JConfig(**TRAIN_CONFIG))
    return [jcollate([ds[i] for i in range(4 * b, 4 * b + 4)], ds.tokenizer, TRAIN_CONFIG["token_buckets"],
                     audio_buckets(ds.config)) for b in range(n_batches)]


def _jax_grad_fn(jtr):
    """The gradient the JAX step takes, by its own loss function (jitted)."""

    def loss_fn(tr, audio, input_tokens, target_tokens, classes, sub, alpha, beta):
        cls_loss, trans_loss, _ = jtr._forward(tr, audio, input_tokens, target_tokens, classes, sub,
                                               train=True, n_valid=jnp.int32(audio.shape[0]))
        a, b = jtr._effective_weights(alpha, beta, cls_loss, trans_loss)
        return a * cls_loss + b * trans_loss

    return jax.jit(jax.grad(loss_fn))


def _jax_step(jtr, batch, grad_fn=None):
    """run_single of the JAX train_epoch, with the keep-mask drawn beside it
    and, given `grad_fn`, the per-group norms of the step's gradient."""
    dev, n_valid = jtr._device_batch(batch)
    jtr._rng, sub = jax.random.split(jtr._rng)
    keep = np.asarray(jax.random.bernoulli(sub, 0.9, (len(batch["classes"]), jtr.model.dims.n_audio_state // 2)))
    args = (dev["audio"], dev["input_tokens"], dev["target_tokens"], dev["classes"])
    weights = (jnp.float32(jtr.alpha), jnp.float32(jtr.beta))
    norms = None
    if grad_fn is not None:
        grads = grad_fn(jtr._trainable(), *args, sub, *weights)
        norms = {}
        for g, lab in zip(jax.tree.leaves(grads), jax.tree.leaves(jtr._optimizer_labels())):
            norms[lab] = norms.get(lab, 0.0) + float(jnp.sum(g.astype(jnp.float32) ** 2))
        norms = {k: np.sqrt(v) for k, v in norms.items()}
    tr, opt, loss, aux = jtr._get_train_step()(jtr._trainable(), jtr.opt_state, *args, *weights, sub,
                                               np.int32(n_valid))
    jtr._set_trainable(tr)
    jtr.opt_state = opt
    if jtr.alpha == 0.0 or jtr.beta == 0.0:
        jtr.alpha, jtr.beta = float(aux["alpha_eff"]), float(aux["beta_eff"])
    return float(loss), aux, keep, norms


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    directory = tmp_path_factory.mktemp("slice")
    jtr = JTrainer(JConfig(**TRAIN_CONFIG, save_dir=str(directory / "jax")), verbose=False)
    ptr = MultiTaskTrainer(TrainingConfig(**TRAIN_CONFIG, device="cpu", save_dir=str(directory / "port")),
                           verbose=False)
    ptr.load_state(state_dict_from_jax_params(np_tree(jtr.model.params), jtr.model.dims),
                   classifier_state_from_jax(np_tree(jtr.classifier_params)))
    return jtr, ptr, directory


def _assert_params_close(jtr, ptr, steps):
    """max |param difference| <= 2 lr steps: the most that a sign flip of an
    AdamW step (|update| <= lr per step) can move a weight."""
    bound = 2 * TRAIN_CONFIG["learning_rate"] * steps
    want = state_dict_from_jax_params(np_tree(jtr.model.params), jtr.model.dims)
    got = ptr.model.state_dict()
    worst = max((got[k].float() - want[k]).abs().max().item() for k in want)
    want_c = classifier_state_from_jax(np_tree(jtr.classifier_params))
    got_c = ptr.classifier.state_dict()
    worst = max(worst, max((got_c[k] - want_c[k]).abs().max().item() for k in want_c))
    assert worst <= bound, (worst, bound)
    return worst


def test_evaluate_and_train_steps_match_jax(pair, tmp_path):
    jtr, ptr, _ = pair
    val = _batches(tmp_path, seed=11, n_batches=1)

    # evaluate from the same carried weights: the metrics are equal
    jm, pm = jtr.evaluate(val), ptr.evaluate(val)
    for key in ("loss", "cls_loss", "trans_loss"):
        assert pm[key] == pytest.approx(jm[key], rel=REL), key
    for key in ("wer", "cer", "disease_acc", "macro_f1"):
        assert pm[key] == pytest.approx(jm[key], abs=1e-12), key

    train = _batches(tmp_path, seed=12, n_batches=STEPS)
    grad_fn = _jax_grad_fn(jtr)
    for step, batch in enumerate(train, 1):
        jloss, jaux, keep, jnorms = _jax_step(jtr, batch, grad_fn if step in (1, STEPS) else None)
        ploss, paux = ptr.train_step(batch, keep=torch.from_numpy(np.array(keep)))
        if step in (1, STEPS):
            assert float(ploss) == pytest.approx(jloss, rel=REL)
            assert float(paux["cls_loss"]) == pytest.approx(float(jaux["cls_loss"]), rel=REL)
            assert float(paux["trans_loss"]) == pytest.approx(float(jaux["trans_loss"]), rel=REL)
            assert ptr.alpha == pytest.approx(jtr.alpha, rel=REL) and ptr.beta == pytest.approx(jtr.beta, rel=REL)
            pnorms = {}  # the step leaves its gradients in .grad
            for name, p in ptr.named_trainable():
                pnorms[group_of(name)] = pnorms.get(group_of(name), 0.0) + float((p.grad.double() ** 2).sum())
            pnorms = {k: np.sqrt(v) for k, v in pnorms.items()}
            assert set(pnorms) == set(jnorms)
            for k in jnorms:
                assert pnorms[k] == pytest.approx(jnorms[k], rel=REL), k
            _assert_params_close(jtr, ptr, step)
    assert ptr.alpha + ptr.beta == pytest.approx(1.0) and 0 < ptr.alpha < 1


def test_checkpoints_cross_load(pair, tmp_path):
    """A checkpoint written by the port loads in the JAX trainer and gives
    the port's evaluation, and the other way round."""
    jtr, ptr, _ = pair
    val = _batches(tmp_path, seed=13, n_batches=1)

    ptr.save_checkpoint(epoch=0, best_loss=1.0)
    j_from_port = JTrainer.load_from_checkpoint(ptr.checkpoint_path(), verbose=False)
    want, got = ptr.evaluate(val), j_from_port.evaluate(val)
    for key in ("loss", "cls_loss", "trans_loss"):
        assert got[key] == pytest.approx(want[key], rel=REL), key
    assert got["wer"] == want["wer"] and got["disease_acc"] == want["disease_acc"]

    jtr.save_checkpoint(epoch=0, best_loss=1.0)
    p_from_jax = MultiTaskTrainer.load_from_checkpoint(jtr.checkpoint_path(), verbose=False, device="cpu")
    want, got = jtr.evaluate(val), p_from_jax.evaluate(val)
    for key in ("loss", "cls_loss", "trans_loss"):
        assert got[key] == pytest.approx(want[key], rel=REL), key
    assert got["wer"] == want["wer"] and got["disease_acc"] == want["disease_acc"]
    assert (p_from_jax.alpha, p_from_jax.beta) == (jtr.alpha, jtr.beta)
