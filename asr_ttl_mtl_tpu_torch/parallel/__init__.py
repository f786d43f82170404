"""Multi-device paths on torch.distributed: the ("dp", "tp") mesh and the
Megatron rules (`mesh`), the collectives (`comm`), data- and
tensor-parallel batched decoding (`serving`), and a spawner of ranks for
scripts and tests (`launch`)."""

from .mesh import (  # noqa: F401
    axis,
    create_mesh,
    init_process_group,
    pad_rows,
    row_block,
    shard_batch,
    shard_params,
    tp_dim,
)
