"""Multi-device mapping of the port: the (data, ref) mesh, the sharded
index and steps, and the ``GDIET_COORDINATOR`` join."""

from gdiet_tpu_torch.parallel.dist import ShardedIndex, make_mesh, sharded_step

__all__ = ["ShardedIndex", "make_mesh", "sharded_step"]
