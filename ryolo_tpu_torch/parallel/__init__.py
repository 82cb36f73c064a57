"""Data parallelism over processes: the mesh, the synced BatchNorm, and
spatial sharding (:mod:`ryolo_tpu_torch.parallel.spatial`)."""

from ryolo_tpu_torch.parallel.mesh import (COLLECTIVES, Mesh,  # noqa: F401
                                           all_reduce_grads, close_mesh,
                                           current_mesh, launch, make_mesh,
                                           replicate, shard_batch)
from ryolo_tpu_torch.parallel.sync_bn import (SyncBatchNorm2d,  # noqa: F401
                                              convert_sync_bn)
