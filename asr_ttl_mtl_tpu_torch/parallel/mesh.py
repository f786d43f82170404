"""The ("dp", "tp") device mesh, the Megatron sharding rules and the batch
placement (counterpart of `asr_ttl_mtl_tpu/parallel/mesh.py`).

The JAX package is single-controller: one process places arrays on many
devices. This port is multi-controller, the PyTorch idiom: one process per
rank, every rank calling the same entry point with the same arguments. The
mesh is a `torch.distributed.device_mesh.DeviceMesh` with the dims
("dp", "tp") over the world's ranks:

  dp - data parallel: each dp rank takes its row block of every batch;
  tp - tensor parallel: each tp rank holds its share of the attention heads
       and of the MLP hidden width (Megatron's layout), and every block
       output is summed over tp once.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# (layer name in the module tree) -> layer name of the JAX parameter tree
_LAYERS = {"query": "query", "key": "key", "value": "value", "out": "out"}
_MLP_LAYERS = {"0": "fc1", "2": "fc2"}


def init_process_group(device: str = "cuda") -> None:
    """Make sure a default process group exists: the caller's, or one from
    torchrun's environment (`env://`), or else a world of one rank. NCCL for
    the card, gloo for the CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def create_mesh(mesh_shape: Tuple[int, int] = (0, 1), device: str = "cuda"):
    """A ("dp", "tp") DeviceMesh over the world's ranks; dp 0 means all the
    ranks that tp leaves. A shape that does not cover the world exactly
    raises. Without a process group, one is made (`init_process_group`)."""
    from torch.distributed.device_mesh import init_device_mesh

    init_process_group(device)
    world = dist.get_world_size()
    dp, tp = (int(v) for v in mesh_shape)
    tp = tp if tp > 0 else 1
    if dp <= 0:
        if world % tp:
            raise ValueError(f"tp {tp} does not divide the world's {world} ranks")
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"mesh ({dp}, {tp}) needs {dp * tp} ranks, but the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


def axis(mesh, name: str):
    """(this rank's coordinate, size, process group) of a mesh dim."""
    return mesh.get_local_rank(name), mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_group(name)


# ---------------------------------------------------------------------------
# the Megatron rules
# ---------------------------------------------------------------------------


def jax_layer(name: str) -> Optional[str]:
    """The JAX layer name (query, key, value, out, fc1, fc2) of a block
    parameter's module tree name, else None."""
    parts = name.split(".")
    if "blocks" not in parts or len(parts) < 3:
        return None
    if parts[-3] == "mlp":
        return _MLP_LAYERS.get(parts[-2])
    return _LAYERS.get(parts[-2])


def tp_dim(name: str) -> Optional[int]:
    """The dim of a parameter (module tree name, torch (out, in) layout)
    that tp shards, or None for a replicated one: the table of JAX
    `_tp_spec_for_path` (:61-82). Column-parallel weights (query, key,
    value, fc1) split their outputs, dim 0, and so do the query, value and
    fc1 biases; row-parallel weights (out, fc2) split their inputs, dim 1;
    everything else (embeddings, convs, layer norms, the row-parallel
    biases) is replicated."""
    layer, kind = jax_layer(name), name.rsplit(".", 1)[-1]
    if kind == "weight" and layer in ("out", "fc2"):
        return 1
    if kind == "weight" and layer in ("query", "key", "value", "fc1"):
        return 0
    if kind == "bias" and layer in ("query", "value", "fc1"):
        return 0
    return None


def _sharded_layers(model, tp: int) -> Dict[str, str]:
    """Module name -> "col" or "row" for every linear that tp shards. The
    port shards attention by whole heads: a block whose head count tp does
    not divide stays replicated on every rank (JAX's GSPMD would split its
    columns mid-head; both compute the same function)."""
    out: Dict[str, str] = {}
    for stack, dims_heads in (("encoder", model.dims.n_audio_head), ("decoder", model.dims.n_text_head)):
        n_state = model.dims.n_audio_state if stack == "encoder" else model.dims.n_text_state
        for i, block in enumerate(getattr(model, stack).blocks):
            prefix = f"{stack}.blocks.{i}"
            attns = ["attn"] + (["cross_attn"] if hasattr(block, "cross_attn") else [])
            if dims_heads % tp == 0:
                for a in attns:
                    for lin in ("query", "key", "value"):
                        out[f"{prefix}.{a}.{lin}"] = "col"
                    out[f"{prefix}.{a}.out"] = "row"
            if (4 * n_state) % tp == 0:
                out[f"{prefix}.mlp.0"] = "col"
                out[f"{prefix}.mlp.2"] = "row"
    return out


def shard_tensor(name: str, t: torch.Tensor, rank: int, tp: int, layers: Dict[str, str]) -> torch.Tensor:
    """This tp rank's share of the parameter `name` (all of it if replicated)."""
    dim = tp_dim(name)
    if dim is None or name.rsplit(".", 1)[0] not in layers:
        return t
    return t.chunk(tp, dim=dim)[rank].contiguous()


def shard_params(model, mesh):
    """The model as this rank holds it under the mesh's tp: a WhisperModel
    whose sharded linears hold their local slices and carry `tp = ("col" |
    "row", tp group)`, which the model's functions read (local heads, the
    all-reduce after a row-parallel product). At tp 1 the model itself.

    The shard is cached on the model per mesh, and made again after any
    in-place change to the model's parameters (as JAX `_tp_params` checks
    the parameter tree, serving.py:107-126): the full model stays beside
    it, for the word alignment."""
    rank, tp, group = axis(mesh, "tp")
    if tp == 1:
        return model
    versions = tuple(p._version for p in model.parameters())
    cache = model.__dict__.setdefault("_tp_shards", {})
    hit = cache.get(id(mesh))
    if hit is not None and hit[0] is mesh and hit[1] == versions:
        return hit[2]
    shard = make_shard(model, rank, tp, group)
    cache[id(mesh)] = (mesh, versions, shard)
    return shard


def make_shard(model, rank: int, tp: int, group):
    """A new WhisperModel holding tp rank `rank`'s slices of `model`'s
    parameters (the buffers shared), its sharded linears tagged."""
    from ..models.registry import WhisperModel

    layers = _sharded_layers(model, tp)
    with torch.device("meta"):
        shard = WhisperModel(model.dims, model.compute_dtype, model.name)
    src = dict(model.named_modules())
    for mname, module in shard.named_modules():
        origin = src[mname]
        for pname, p in list(origin.named_parameters(recurse=False)):
            full = f"{mname}.{pname}" if mname else pname
            local = shard_tensor(full, p.detach(), rank, tp, layers)
            module._parameters[pname] = nn.Parameter(local.clone(), requires_grad=p.requires_grad)
        for bname, b in origin.named_buffers(recurse=False):
            module._buffers[bname] = b
        if mname in layers:
            module.tp = (layers[mname], group)
    shard.alignment_heads = np.array(model.alignment_heads, copy=True)
    shard.train(model.training)
    return shard


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def pad_rows(x, multiple: int, repeat_last: bool = False):
    """x (numpy or torch) with its rows padded up to a multiple: zeros, or
    copies of the last row."""
    n = x.shape[0]
    pad = -n % multiple
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        tail = x[-1:].expand(pad, *x.shape[1:]) if repeat_last else x.new_zeros((pad, *x.shape[1:]))
        return torch.cat([x, tail])
    tail = np.repeat(x[-1:], pad, axis=0) if repeat_last else np.zeros((pad, *x.shape[1:]), x.dtype)
    return np.concatenate([x, tail])


def row_block(x, mesh):
    """This dp rank's contiguous block of x's rows (the rows must divide)."""
    rank, dp, _ = axis(mesh, "dp")
    n = x.shape[0]
    if n % dp:
        raise ValueError(f"{n} rows do not divide over dp {dp}")
    size = n // dp
    return x[rank * size : (rank + 1) * size]


def shard_batch(batch: Dict, mesh) -> Dict:
    """Each array of the batch cut to this dp rank's row block (JAX
    `shard_batch` puts the same blocks on the dp devices); other values
    pass through."""
    return {k: row_block(v, mesh) if hasattr(v, "shape") and len(v.shape) else v for k, v in batch.items()}
