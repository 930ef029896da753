"""The search driver (the reference's ``MAIN()``, ``demod_binary.c:117``):
the process around one :class:`~.session.Session` — the argument surface,
the BOINC slot's ``init_data.xml``, the device choice, signal handling and
the RADPUL_* exit codes.

Checkpoint compatibility: the card holds (M, T) per-bin maxima; a
checkpoint stores the reference's 500-candidate toplist built from them,
and a resumed run reseeds those candidates as virtual templates, so the
port and the JAX package resume each other's checkpoints.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace

from . import logging as erplog
from .boinc import BoincAdapter, restore_signal_handlers
from .errors import RADPUL_EIO, RADPUL_EVAL, RadpulError, exit_code_for


@dataclass
class DriverArgs:
    """The reference's command-line surface (``demod_binary.c:217-445``),
    plus the batch size, oracle rescoring, the device and the BOINC
    wrapper's files."""

    inputfile: str
    outputfile: str
    templatebank: str
    checkpointfile: str | None = None
    zaplistfile: str | None = None
    f0: float = 250.0
    padding: float = 1.0
    fA: float = 0.04
    window: int = 1000
    white: bool = False
    debug: bool = False
    batch_size: int = 16
    # host-oracle rescoring of the emitted candidates (oracle/rescore.py),
    # off with --no-rescore
    rescore: bool = True
    # torch device: "cuda" (the current card), "cuda:N" (-D N) or "cpu";
    # a BOINC-assigned card in init_data.xml takes precedence over a card
    device: str = "cuda"
    # the native wrapper's protocol (runtime/boinc.py, native/erp_wrapper.cpp)
    status_file: str | None = None
    control_file: str | None = None
    shmem: str | None = None


def make_adapter(args: DriverArgs) -> BoincAdapter:
    """The BOINC adapter, wired for wrapper mode when the wrapper passed
    status, control or shared-memory paths."""
    from .shmem import ShmemWriter

    return BoincAdapter(
        status_path=args.status_file,
        control_path=args.control_file,
        shmem=ShmemWriter(path=args.shmem) if args.shmem else None,
    )


def device_for(args: DriverArgs, init_data=None) -> str:
    """The device this run uses: a card that BOINC assigned in
    ``init_data.xml`` (``gpu_device_num``) takes precedence over ``-D`` and
    ``--device cuda:N`` (``cuda_utilities.c:44-85``); a run asked onto the
    CPU stays there."""
    if init_data is not None and init_data.gpu_device_num is not None and not args.device.startswith("cpu"):
        erplog.info("Using BOINC-assigned device #%d (init_data.xml).\n", init_data.gpu_device_num)
        return f"cuda:{init_data.gpu_device_num}"
    return args.device


def _select_device(args: DriverArgs, init_data) -> str:
    import torch

    from ..device import resolve_device

    dev = resolve_device(device_for(args, init_data))
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if dev.index >= count:
            raise RadpulError(
                RADPUL_EVAL, f"No device matching the given device ID #{dev.index} found ({count} available)!"
            )
        erplog.info('Using CUDA device #%d "%s"\n', dev.index, torch.cuda.get_device_name(dev))
    return str(dev)


def _run_search(args: DriverArgs, adapter: BoincAdapter) -> int:
    from .initdata import load_init_data
    from .session import Session

    erplog.info("Starting data processing...\n")
    # BOINC slot: device assignment and user/host provenance
    # (cuda_utilities.c:53-85, demod_binary.c:1591-1605)
    init_data = load_init_data()
    if init_data is None:
        erplog.warn("User/host details unavailable...\n")
    args = replace(args, device=_select_device(args, init_data))
    # graceful quit: SIGTERM/SIGINT set the adapter's quit flag, so the
    # batch loop checkpoints and exits (erp_boinc_wrapper.cpp:143-152)
    previous = adapter.install_signal_handlers() if threading.current_thread() is threading.main_thread() else {}
    try:
        return Session(args, adapter, init_data=init_data).run()
    finally:
        restore_signal_handlers(previous)


def run_search(args: DriverArgs, adapter: BoincAdapter | None = None) -> int:
    """Returns 0 on success (or after a quit, checkpointed), a RADPUL_*
    error code otherwise."""
    try:
        return _run_search(args, adapter or make_adapter(args))
    except FileNotFoundError as e:
        erplog.error("Couldn't open file: %s\n", e)
        return RADPUL_EIO
    except Exception as e:
        code = exit_code_for(e)
        if code is None:
            raise
        erplog.error("%s\n", e)
        return code
