"""Multi-process identity of a search, and ``torch.distributed`` bring-up.

One workunit's template bank can be shared by several processes (hosts,
or several processes on one card).  Two modes, both set by the
environment, with the JAX package's names:

* **Coordinated** (``ERP_COORDINATOR`` set, ``host:port``):
  :func:`initialize` brings up a ``torch.distributed`` process group over
  gloo (``init_method=tcp://ERP_COORDINATOR``) with the rank
  ``ERP_PROCESS_ID`` and world size ``ERP_NUM_PROCESSES``.  It carries
  identity and barriers only: no collective crosses processes on the
  search path.
* **Uncoordinated** (``ERP_NUM_PROCESSES`` > 1 without a coordinator):
  identity comes from the environment alone and no process group is
  made.  Everything that crosses processes goes through the shard-lease
  board on a shared directory (``ERP_SHARD_DIR``, ``parallel/elastic.py``),
  which is what makes the loss of a process survivable: there is no
  collective for the survivors to hang in.

``ERP_LOCAL_DEVICES=K`` makes a run on the CPU hold K logical CPU shards
(``parallel/mesh.py::local_devices``): the chip-free stand-in for the JAX
package's forced host devices, so N processes of K shards model N hosts
of K cards on one machine.  On a card it changes nothing.

The driver calls :func:`initialize` before it chooses the devices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

ENV_COORDINATOR = "ERP_COORDINATOR"  # host:port of process 0's store
ENV_PROCESS_ID = "ERP_PROCESS_ID"
ENV_NUM_PROCESSES = "ERP_NUM_PROCESSES"
ENV_LOCAL_DEVICES = "ERP_LOCAL_DEVICES"  # logical CPU shards of a CPU run
ENV_SHARD_DIR = "ERP_SHARD_DIR"  # shard-lease board root (elastic mode)


class DistributedConfigError(ValueError):
    """Malformed multi-process environment (bad id or count)."""


@dataclass(frozen=True)
class DistributedConfig:
    """Identity of this process within a multi-process search."""

    num_processes: int
    process_id: int
    coordinator: str | None = None
    local_devices: int | None = None
    shard_dir: str | None = None

    @property
    def host_id(self) -> str:
        """Stable logical host name used in leases, heartbeats and events."""
        return f"host{self.process_id}"

    @property
    def coordinated(self) -> bool:
        return self.coordinator is not None


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise DistributedConfigError(f"{name}={raw!r} is not an integer.") from None


def local_cpu_devices() -> int:
    """The logical CPU shards of this process: ``ERP_LOCAL_DEVICES``, 1
    when unset."""
    k = _env_int(ENV_LOCAL_DEVICES)
    if k is None:
        return 1
    if k < 1:
        raise DistributedConfigError(f"{ENV_LOCAL_DEVICES} must be >= 1.")
    return k


def config_from_env() -> DistributedConfig | None:
    """The multi-process config this environment describes, or None for a
    plain single-process run (``ERP_NUM_PROCESSES`` unset or <= 1 and no
    coordinator)."""
    coordinator = os.environ.get(ENV_COORDINATOR) or None
    n_proc = _env_int(ENV_NUM_PROCESSES)
    proc_id = _env_int(ENV_PROCESS_ID)
    if coordinator is None and (n_proc is None or n_proc <= 1):
        return None
    if n_proc is None or n_proc < 1:
        raise DistributedConfigError(
            f"{ENV_COORDINATOR} is set but {ENV_NUM_PROCESSES} is not: a coordinated run needs an explicit "
            "process count."
        )
    if proc_id is None:
        raise DistributedConfigError(f"{ENV_NUM_PROCESSES}={n_proc} but {ENV_PROCESS_ID} is unset.")
    if not 0 <= proc_id < n_proc:
        raise DistributedConfigError(f"{ENV_PROCESS_ID}={proc_id} out of range for {ENV_NUM_PROCESSES}={n_proc}.")
    local = _env_int(ENV_LOCAL_DEVICES)
    if local is not None and local < 1:
        raise DistributedConfigError(f"{ENV_LOCAL_DEVICES} must be >= 1.")
    return DistributedConfig(
        num_processes=n_proc,
        process_id=proc_id,
        coordinator=coordinator,
        local_devices=local,
        shard_dir=os.environ.get(ENV_SHARD_DIR) or None,
    )


_active: DistributedConfig | None = None
_initialized = False
_owns_group = False


def initialize(cfg: DistributedConfig | None = None) -> DistributedConfig | None:
    """Arm this process's multi-process identity (idempotent): the config
    of the environment (or ``cfg``), with a gloo process group in
    coordinated mode.  Returns the active config (None: single-process)."""
    global _active, _initialized, _owns_group
    if _initialized:
        return _active
    if cfg is None:
        cfg = config_from_env()
    _initialized = True
    if cfg is None:
        return None
    from ..runtime import logging as erplog

    if cfg.coordinated:
        import torch.distributed as tdist

        erplog.info(
            "Initializing torch.distributed (gloo): process %d/%d, coordinator %s\n",
            cfg.process_id, cfg.num_processes, cfg.coordinator,
        )
        tdist.init_process_group(
            "gloo", init_method=f"tcp://{cfg.coordinator}",
            world_size=cfg.num_processes, rank=cfg.process_id,
        )
        _owns_group = True
    else:
        erplog.info(
            "Multi-host search (uncoordinated): process %d/%d, cross-host merge via the shard board.\n",
            cfg.process_id, cfg.num_processes,
        )
    _active = cfg
    return _active


def context() -> DistributedConfig | None:
    """The active config, initialised from the environment on first use."""
    if not _initialized:
        return initialize()
    return _active


def reset() -> None:
    """Forget the active config and end the process group this module
    made (tests; a real run initialises once)."""
    global _active, _initialized, _owns_group
    if _owns_group:
        import torch.distributed as tdist

        if tdist.is_initialized():
            tdist.destroy_process_group()
        _owns_group = False
    _active = None
    _initialized = False


def shard_ranges(n_templates: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous balanced template ranges ``[(a0, b0), ...]`` covering
    ``[0, n_templates)``.  Sizes differ by at most one; with more shards
    than templates the tail shards are empty (``a == b``) and complete
    trivially.  Contiguity keeps "earlier shard" == "earlier template",
    which the merge's smallest-index tie-break relies on."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    base, extra = divmod(max(0, n_templates), n_shards)
    ranges = []
    a = 0
    for k in range(n_shards):
        b = a + base + (1 if k < extra else 0)
        ranges.append((a, b))
        a = b
    return ranges
