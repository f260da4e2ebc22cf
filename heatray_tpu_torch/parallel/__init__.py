"""Multi-device sharding over ``torch.distributed`` (dp over pixel rows, sp
over samples; ``geometry``: the host-sharded geometry of the ``"sharded"``
backend)."""

from .sharding import (
    make_mesh,
    make_sharded_train_step,
    render_sharded,
    replicate,
    shard_context,
    sharded_accum,
)

__all__ = [
    "make_mesh",
    "make_sharded_train_step",
    "render_sharded",
    "replicate",
    "shard_context",
    "sharded_accum",
]
