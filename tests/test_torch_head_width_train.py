"""One train step at head widths 32, 128, 192 and 256: the port's
MultiTaskTrainer against the JAX package's loss function on the same
carried weights, batch and dropout keep-mask, at the training test set-up
of torch_port_helpers with d 128 and 4 heads (dh 32), d 256 and 2 heads (dh
128), d 384 and 2 heads (dh 192: K8's wide backward on the card) and d 512
and 2 heads (dh 256)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.mtl import MultiTaskTrainer as JTrainer
from asr_ttl_mtl_tpu.mtl import TrainingConfig as JConfig
from asr_ttl_mtl_tpu.mtl import MultiTaskSpeechDataset as JDataset
from asr_ttl_mtl_tpu.mtl import collate as jcollate
from asr_ttl_mtl_tpu.mtl.dataset import audio_buckets
from asr_ttl_mtl_tpu_torch.models import state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of
from asr_ttl_mtl_tpu_torch.mtl.trainer import classifier_state_from_jax

from torch_port_helpers import DEBUG_DIMS, TRAIN_CONFIG, np_tree, write_wav_dataset

REL = 1e-4  # the loss and gradient norms, as test_torch_trainer.py holds them
# head width -> (d, n_head)
WIDTHS = {32: (128, 4), 128: (256, 2), 192: (384, 2), 256: (512, 2)}


@pytest.mark.parametrize("dh", sorted(WIDTHS))
def test_train_step_matches_jax(dh, tmp_path):
    """One MultiTaskTrainer step from the same carried weights, batch and
    dropout keep-mask: the loss and every group's gradient norm within 1e-4
    of the JAX step's (its loss function's value and gradient)."""
    d, n_head = WIDTHS[dh]
    cfg = dict(TRAIN_CONFIG, debug_dims=dict(DEBUG_DIMS, n_audio_state=d, n_audio_head=n_head, n_text_state=d,
                                             n_text_head=n_head))
    jtr = JTrainer(JConfig(**cfg, save_dir=str(tmp_path / "jax")), verbose=False)
    ptr = MultiTaskTrainer(TrainingConfig(**cfg, device="cpu", save_dir=str(tmp_path / "port")), verbose=False)
    ptr.load_state(state_dict_from_jax_params(np_tree(jtr.model.params), jtr.model.dims),
                   classifier_state_from_jax(np_tree(jtr.classifier_params)))
    ds = JDataset(write_wav_dataset(tmp_path, n=4, seed=16 + dh), JConfig(**cfg))
    batch = jcollate([ds[i] for i in range(4)], ds.tokenizer, cfg["token_buckets"], audio_buckets(ds.config))

    dev, n_valid = jtr._device_batch(batch)
    _, sub = jax.random.split(jtr._rng)
    keep = np.array(jax.random.bernoulli(sub, 0.9, (len(batch["classes"]), d // 2)))

    def loss_fn(tr):
        cls_loss, trans_loss, _ = jtr._forward(tr, dev["audio"], dev["input_tokens"], dev["target_tokens"],
                                               dev["classes"], sub, train=True, n_valid=jnp.int32(n_valid))
        a, b = jtr._effective_weights(jnp.float32(jtr.alpha), jnp.float32(jtr.beta), cls_loss, trans_loss)
        return a * cls_loss + b * trans_loss

    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(jtr._trainable())
    jnorms = {}
    for g, lab in zip(jax.tree.leaves(grads), jax.tree.leaves(jtr._optimizer_labels())):
        jnorms[lab] = jnorms.get(lab, 0.0) + float(jnp.sum(g.astype(jnp.float32) ** 2))

    ploss, _ = ptr.train_step(batch, keep=torch.from_numpy(keep))
    pnorms = {}
    for name, p in ptr.named_trainable():
        pnorms[group_of(name)] = pnorms.get(group_of(name), 0.0) + float((p.grad.double() ** 2).sum())
    assert float(ploss) == pytest.approx(float(jloss), rel=REL)
    assert set(pnorms) == set(jnorms)
    for key in jnorms:
        assert np.sqrt(pnorms[key]) == pytest.approx(np.sqrt(jnorms[key]), rel=REL), key
