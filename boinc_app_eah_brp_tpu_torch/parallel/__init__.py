"""Several devices and several processes on one workunit.

* In one process: template blocks sharded over a mesh of devices
  (``mesh.py``; ``sharded_search.py``), each shard running the port's
  batch step on its device, the shards' (M, T) states folded by the
  max/argmax merge that keeps the smallest template index on ties.
* Across processes: contiguous template-range shards under leases with
  heartbeats and adoption (``distributed.py``, ``elastic.py``, the lease
  board of ``runtime/resilience.py``); the cross-process merge is a
  host-side fold of committed shard states, so the loss of a process is a
  survivable fault instead of a hung collective.
"""

from .distributed import DistributedConfig, config_from_env, shard_ranges
from .elastic import run_bank_elastic
from .mesh import make_mesh
from .sharded_search import make_sharded_batch_step, run_bank_sharded

__all__ = [
    "DistributedConfig",
    "config_from_env",
    "make_mesh",
    "make_sharded_batch_step",
    "run_bank_elastic",
    "run_bank_sharded",
    "shard_ranges",
]
