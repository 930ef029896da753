"""The search driver (the reference's ``MAIN()``, ``demod_binary.c:117``):
the process around one :class:`~.session.Session` — the argument surface,
the observability and resilience layers armed for the run (metrics,
tracing, the flight recorder, the watchdog, fault injection, the retry
budget) and closed after it, the BOINC slot's ``init_data.xml``, the
multi-process identity (``parallel/distributed.py``), the device and
mesh choice, signal handling and the RADPUL_* exit codes.

Checkpoint compatibility: the card holds (M, T) per-bin maxima; a
checkpoint stores the reference's 500-candidate toplist built from them,
and a resumed run reseeds those candidates as virtual templates, so the
port and the JAX package resume each other's checkpoints.
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, replace

from . import faultinject, flightrec, metrics, resilience, steptime, tracing, watchdog
from . import logging as erplog
from .boinc import BoincAdapter, restore_signal_handlers
from .errors import RADPUL_EIO, RADPUL_EVAL, RadpulError, exit_code_for


@dataclass
class DriverArgs:
    """The reference's command-line surface (``demod_binary.c:217-445``),
    plus the batch size, oracle rescoring, the device, the BOINC wrapper's
    files and the observability outputs."""

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
    # batch size: None = auto (measured sweep or memory model,
    # runtime/autobatch.py); --batch N pins it
    batch_size: int | None = None
    # host-oracle rescoring of the emitted candidates (oracle/rescore.py),
    # off with --no-rescore
    rescore: bool = True
    # the reference's LUT sine; False (--exact-sin): the exact-sine kernels
    use_lut: bool = True
    # torch device: "cuda" (the current card), "cuda:N" (-D N) or "cpu";
    # a BOINC-assigned card in init_data.xml takes precedence over a card
    device: str = "cuda"
    # --mesh N: shard the template bank over N devices (None = every
    # visible card, or ERP_LOCAL_DEVICES logical shards of a CPU run)
    mesh_devices: int | None = None
    # the native wrapper's protocol (runtime/boinc.py, native/erp_wrapper.cpp)
    status_file: str | None = None
    control_file: str | None = None
    shmem: str | None = None
    # torch.profiler trace directory (also $ERP_PROFILE_DIR; runtime/profiling.py)
    profile_dir: str | None = None
    # metrics JSONL stream + run report (also $ERP_METRICS_FILE; runtime/metrics.py)
    metrics_file: str | None = None


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


def _select_devices(args: DriverArgs, init_data) -> tuple[str, int]:
    """The run's device and the width of its mesh (1: the single-device
    path), with the JAX package's checks (its ``_select_devices``): a
    pinned card (``-D``, ``--device cuda:N`` or BOINC's assignment) with
    ``--mesh N>1``, or a mesh wider than the devices this process
    addresses, is RADPUL_EVAL; with no ``--mesh`` the mesh spans every
    visible card (on the CPU, ``ERP_LOCAL_DEVICES`` logical shards)."""
    import torch

    from ..device import resolve_device
    from ..parallel.mesh import local_devices

    chosen = device_for(args, init_data)
    pinned = chosen.startswith("cuda:")
    if pinned and (args.mesh_devices or 0) > 1:
        raise RadpulError(RADPUL_EVAL, "-D/--device and --mesh N>1 are mutually exclusive.")
    if chosen.startswith("cpu"):
        dev = resolve_device(chosen)
    else:
        # CUDA's driver and the chosen card's context, made here at a
        # named point, not inside whichever call first touches the card
        with tracing.span("cuda-init", device=chosen):
            dev = resolve_device(chosen)
            if dev.index < torch.cuda.device_count():
                torch.cuda.synchronize(dev)
    visible = local_devices(dev.type)
    if pinned and dev.index >= len(visible):
        raise RadpulError(
            RADPUL_EVAL, f"No device matching the given device ID #{dev.index} found ({len(visible)} available)!"
        )
    n_mesh = 1 if pinned else len(visible)
    if args.mesh_devices is not None:
        if args.mesh_devices > len(visible):
            raise RadpulError(
                RADPUL_EVAL,
                f"Requested a {args.mesh_devices}-device mesh but {len(visible)} devices are available!",
            )
        n_mesh = args.mesh_devices
    if dev.type == "cuda":
        erplog.info('Using CUDA device #%d "%s"\n', dev.index, torch.cuda.get_device_name(dev))
    if n_mesh > 1:
        erplog.info("Using %d %s device(s).\n", n_mesh, dev.type)
    return str(dev), n_mesh


def _run_search(args: DriverArgs, adapter: BoincAdapter) -> int:
    # the process's start on the host timeline: the session's modules
    # (torch with them), the multi-process identity and the devices
    with tracing.span("startup"):
        with tracing.span("import"):
            from ..models import search  # noqa: F401  (the search and its kernels' wrappers)
            from ..oracle import rescore  # noqa: F401
            from .initdata import load_init_data
            from .session import Session

        erplog.info("Starting data processing...\n")
        # the fault-injection schedule, loudly (a malformed ERP_FAULT_SPEC is a
        # usage error: RADPUL_EVAL through the ValueError mapping), and a fresh
        # retry budget for every resilience site
        if faultinject.configure():
            erplog.warn("Fault injection armed: ERP_FAULT_SPEC=%s\n", os.environ.get(faultinject.ENV_SPEC, ""))
        resilience.begin_run()
        # multi-process identity (parallel/distributed.py) before the devices
        from ..parallel import distributed

        dist = distributed.initialize()
        if dist is not None and dist.shard_dir is None:
            raise RadpulError(
                RADPUL_EVAL,
                f"Multi-host run ({distributed.ENV_NUM_PROCESSES}={dist.num_processes}) needs "
                f"{distributed.ENV_SHARD_DIR} pointing at a directory every host can reach.",
            )
        # BOINC slot: device assignment and user/host provenance
        # (cuda_utilities.c:53-85, demod_binary.c:1591-1605)
        init_data = load_init_data()
        if init_data is None:
            erplog.warn("User/host details unavailable...\n")
        device, n_mesh = _select_devices(args, init_data)
    args = replace(args, device=device)
    # graceful quit: SIGTERM/SIGINT set the adapter's quit flag, so the
    # batch loop checkpoints and exits (erp_boinc_wrapper.cpp:143-152)
    previous = adapter.install_signal_handlers() if threading.current_thread() is threading.main_thread() else {}
    try:
        return Session(args, adapter, init_data=init_data).run(n_mesh=n_mesh, dist=dist)
    finally:
        restore_signal_handlers(previous)


def run_search(args: DriverArgs, adapter: BoincAdapter | None = None) -> int:
    """Returns 0 on success (or after a quit, checkpointed), a RADPUL_*
    error code otherwise."""
    metrics.configure(metrics_file=args.metrics_file)
    # host span timeline ($ERP_TRACE_FILE), armed before any phase bracket
    if tracing.configure():
        metrics.note_host_trace(os.environ.get(tracing.TRACE_FILE_ENV, ""))
    # black box: ring and crash hooks for the whole run; the dump lands
    # next to the checkpoint (the one directory known to be writable)
    dump_dir = next((os.path.dirname(os.path.abspath(p)) for p in (args.checkpointfile, args.outputfile) if p), None)
    context = {"inputfile": args.inputfile, "templatebank": args.templatebank, "checkpointfile": args.checkpointfile}
    corr_id = os.environ.get(metrics.CORR_ID_ENV)
    if corr_id:
        context["corr_id"] = corr_id
    flightrec.arm(dump_dir=dump_dir, context=context)
    # hang doctor: per-stage deadlines turn a wedge into a supervised
    # restart; the incident log remembers which template window was in
    # flight, so a repeat offender is quarantined on a later pass
    incident_path = watchdog.default_incident_path(args.checkpointfile)
    watchdog.arm(incident_log=watchdog.IncidentLog(incident_path) if incident_path else None)
    code: int | None = None
    try:
        code = _run_search(args, adapter or make_adapter(args))
        return code
    except FileNotFoundError as e:
        erplog.error("Couldn't open file: %s\n", e)
        code = RADPUL_EIO
        return code
    except Exception as e:
        mapped = exit_code_for(e)
        if mapped is None:
            raise
        erplog.error("%s\n", e)
        code = mapped
        return code
    finally:
        if code != 0:
            # a dump on any non-success exit, before the run report closes
            flightrec.dump(f"exit-code-{code}" if code is not None else "unhandled-exception", exc=sys.exc_info()[1])
        else:
            flightrec.disarm()
        # the supervisor thread must not outlive the run it watches
        watchdog.disarm()
        tracing.finish(code)
        steptime.finish(code)
        # the process's kernel launches, one gauge a kernel entry, in the run report
        from ..ops import kernels

        for name, n in kernels.launch_counts.items():
            metrics.gauge(f"torch.kernel_launches.{name}").set(n)
        metrics.finish(code, context={"inputfile": args.inputfile, "templatebank": args.templatebank})
