"""Data- and tensor-parallel batched decoding over a ("dp", "tp") mesh
(counterpart of `asr_ttl_mtl_tpu/parallel/serving.py`).

Every rank calls these with the same arguments. The window batch is padded
with zero windows to a multiple of dp, and each dp rank decodes its row
block with `DecodingTask` (greedy, best-of or beam, with `kv_quant` and
`int8_encoder`) on the model as its tp rank holds it
(`mesh.shard_params`), the kernels live at the local shapes. Then one
`all_gather` over dp brings every rank the token buffers, the log-prob
sums and the no-speech probabilities of the whole batch, the pad rows are
dropped, and every rank assembles the same results.

The JAX package runs tp and best-of sampling as one global program with
its kernels off (GSPMD cannot partition `pallas_call`); here the kernels
stay on under tp, since each rank computes at its local shapes. A sampled
rung draws its noise for the whole batch on every rank and takes its own
rows, so a dp run samples what one process samples, which is what the JAX
package's global program gives it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .comm import gather_rows
from .mesh import axis, create_mesh, pad_rows, row_block, shard_params


def decode_batched_dp(model, mels, options=None, mesh=None, rng_seed: int = 0, **option_kwargs) -> List:
    """Decode a batch of 30 s mel windows over the mesh: dp shares out the
    windows, tp the weights. The results of `DecodingTask.run` (known
    language), on every rank."""
    return collect_batched_dp(dispatch_batched_dp(model, mels, options, mesh, rng_seed, **option_kwargs))


def dispatch_batched_dp(model, mels, options=None, mesh=None, rng_seed: int = 0, **option_kwargs):
    """Enqueue this rank's row block of the batch and return a handle for
    `collect_batched_dp`; nothing here waits for the device, so
    `transcribe_batch` keeps the next chunk in flight while this one is
    collected."""
    from ..decoding import DecodingOptions, DecodingTask

    if options is None:
        options = DecodingOptions(**option_kwargs)
    if options.language is None:
        raise ValueError("decode_batched_dp needs a known language")
    mesh = mesh or create_mesh((0, 1), device=model.device.type)
    rank, dp, _ = axis(mesh, "dp")
    task = DecodingTask(shard_params(model, mesh), options)

    mels = torch.as_tensor(mels).to(model.device)
    n_audio = mels.shape[0]
    local = row_block(pad_rows(mels, dp), mesh)
    handle = task.submit(local, rng_seed, rows=(rank * local.shape[0], n_audio))
    return task, handle, mesh, n_audio


def collect_batched_dp(handle) -> List:
    """Gather the dp blocks' outputs on every rank, drop the pad rows and
    assemble the results."""
    from ..beam import collect_beam

    task, (assemble, languages, _feats), mesh, n_audio = handle
    _, dp, group = axis(mesh, "dp")
    if assemble.func is collect_beam:
        arrays, (b_local, k, valid_len), eot = assemble.args
        *on_card, n_sampled = arrays
        *gathered, steps = gather_rows([*on_card, torch.tensor(float(n_sampled), device=on_card[0].device)],
                                       group)
        outs = (*gathered, int(steps.max()))
        tokens, sum_lp, ns_probs = collect_beam(outs, (b_local * dp, k, valid_len), eot)
    else:
        buf, sum_lp, ns_probs, n_sampled, b_local, n_group, valid_len = assemble.args
        buf, sum_lp, ns_probs, steps = gather_rows(
            [buf, sum_lp, ns_probs, torch.tensor(float(n_sampled), device=buf.device)], group)
        tokens, sum_lp, ns_probs = task._assemble_greedy(buf, sum_lp, ns_probs, int(steps.max()), b_local * dp,
                                                         n_group, valid_len)
    languages = [languages[0]] * n_audio
    return task._finalize(tokens[:n_audio], sum_lp[:n_audio], np.asarray(ns_probs)[:n_audio], languages)
