"""The device list of the template-sharded search.

One logical axis, ``"templates"``: the bank is cut into per-shard blocks
over it (``parallel/sharded_search.py``).  A mesh is this process's own
devices: in a multi-process run the processes share the bank through the
shard-lease board (``parallel/elastic.py``), never a mesh, so a lost
process cannot hang the others.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import distributed

TEMPLATE_AXIS = "templates"


@dataclass(frozen=True)
class Mesh:
    """A 1-D list of ``torch.device``s along ``axis_name``; shard ``i``
    runs on ``devices[i]``."""

    devices: tuple[torch.device, ...]
    axis_name: str = TEMPLATE_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card, ``cuda:N`` and ``cpu`` as they are."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices(platform: str = "cuda") -> list[torch.device]:
    """The devices this process can shard over: every visible card, or on
    the CPU ``ERP_LOCAL_DEVICES`` logical shards of the one CPU device."""
    if platform == "cpu":
        return [torch.device("cpu")] * distributed.local_cpu_devices()
    if platform != "cuda":
        raise ValueError(f"unsupported platform {platform!r}: use 'cuda' or 'cpu'")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: int | None = None,
    devices=None,
    axis_name: str = TEMPLATE_AXIS,
    platform: str = "cuda",
) -> Mesh:
    """A mesh over the first ``n_devices`` of this process's devices
    (:func:`local_devices` of ``platform``; all of them when None), or over
    the explicit ``devices`` list.

    An explicit list may repeat a device: several shards then share that
    device and its default stream.  That is how the CPU tests and
    ``chip_smoke.py`` run several shards on one device; the command line
    never builds such a mesh.  Asking for more devices than the process
    can address is an error, as in the JAX package's ``make_mesh``."""
    if devices is not None:
        devs = tuple(_indexed(torch.device(d)) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices were given")
        return Mesh(devs, axis_name)
    local = local_devices(platform)
    if n_devices is None:
        n_devices = len(local)
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got n_devices={n_devices}")
    if n_devices > len(local):
        cfg = distributed.context()
        if cfg is not None and cfg.num_processes > 1:
            raise ValueError(
                f"Requested {n_devices} devices but process {cfg.process_id}/{cfg.num_processes} addresses only "
                f"{len(local)}. Meshes are host-local; shard templates across hosts with parallel.elastic instead."
            )
        raise ValueError(f"Requested {n_devices} devices but only {len(local)} are available.")
    return Mesh(tuple(local[:n_devices]), axis_name)
