"""Multi-device propagation over a grid of torch devices.

Counterpart of ``astroz_tpu/parallel``: one process drives a ``(time,
sat)`` grid of devices (:class:`~.mesh.Mesh`), as the JAX package drives
a ``jax.sharding.Mesh`` from one controller. Each shard's tensors live
on its device, its kernels go out on that device's stream, and results
are gathered onto the first device. A mesh may name a device more than
once (``[torch.device("cpu")] * 8`` in the tests, ``[cuda:0] * 4`` on
one card), the counterpart of JAX's virtual host devices.
"""

from .mesh import (Mesh, ShardedCatalog, make_mesh, pad_catalog,
                   propagate_sharded, propagate_sharded_fast, shard_catalog,
                   stage_sharded_fast)

__all__ = ["Mesh", "ShardedCatalog", "make_mesh", "pad_catalog",
           "shard_catalog", "propagate_sharded", "propagate_sharded_fast",
           "stage_sharded_fast"]
