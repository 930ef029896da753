"""Command line of the port: the reference's flags
(``demod_binary.c:217-445``) and the JAX package's extensions that the
port honours, with the same range checks and exit codes, so BOINC
``app_info.xml`` command lines work unchanged.  ``--device`` takes a torch
device (``cuda``, ``cuda:N`` or ``cpu``); ``-D N`` is ``cuda:N``, which
pins one card and so excludes ``--mesh N`` above 1.  ``-i`` and ``-o``
repeat, as the reference wrapper's do: each pair is one pass of the task,
searched in order in this process (``runtime/driver.py``)."""

from __future__ import annotations

import sys

from . import logging as erplog
from .driver import DriverArgs, run_search
from .errors import RADPUL_EFILE, RADPUL_EMEM, RADPUL_EMISC, RADPUL_EVAL

_USAGE = """
Usage: {prog} [options], options are:

 -h, --help\t\t\tboolean\tPrint this message
 -i, --input_file\t\tstring\tThe name of the input file (repeatable: one pass each, paired with -o in order).
 -o, --output_file\t\tstring\tThe name of the candidate output file (repeatable, one each -i).
 -t, --template_bank\t\tstring\tThe name of the random template bank.
 -c, --checkpoint_file\t\tstring\tThe name of the checkpoint file.
 -l, --zaplist_file\t\tstring\tThe name of the zaplist file.
 -f, --f0\t\t\tfloat\tThe maximum signal frequency (in Hz)
 -A, --false_alarm\t\tfloat\tFalse alarm probability.
 -P, --padding\t\t\tfloat\tThe frequency over-resolution factor.
 -W, --whitening\t\tboolean\tSwitch for power spectrum whitening and line zapping.
 -B, --box\t\t\tint\tWindow width for the running median in frequeny bins.
 -D\t\t\t\tinteger\tThe CUDA device ID to be used.
 -z, --debug\t\t\tboolean\tRun program in debug mode.
 --batch\t\t\tint\tTemplates per device batch (default: auto, from a measured sweep or the card's memory).
 --device\t\t\tstring\tTorch device: cuda (default), cuda:N or cpu.
 --no-rescore\t\tboolean\tSkip host-oracle rescoring of emitted candidates.
 --mesh\t\t\tint\tShard the template bank over an N-device mesh (default: all visible devices).
 --exact-sin\t\tboolean\tUse exact sine instead of the reference LUT.
 --status-file\t\tstring\tProgress sink when run under the native wrapper.
 --control-file\t\tstring\tQuit/abort source when run under the native wrapper.
 --shmem\t\t\tstring\tScreensaver shared-memory segment path.
 --profile-dir\t\tstring\tCapture a torch.profiler trace of the search loop into this directory.
 --metrics-file\t\tstring\tAppend a structured metrics JSONL stream (+ run report) to this file.
 --supervised\t\tint\tRe-exec the worker on watchdog temporary exit (rc 99), resuming from the checkpoint, up to N restarts.
"""

_NUMBERS = {
    "-P": ("padding", float, 1.0, 10.0, "padding factor"),
    "--padding": ("padding", float, 1.0, 10.0, "padding factor"),
    "-B": ("window", int, 2, 250000, "window size for running median"),
    "--box": ("window", int, 2, 250000, "window size for running median"),
    "-f": ("f0", float, 0.0, 16.0e3, "upper limit for search frequency"),
    "--f0": ("f0", float, 0.0, 16.0e3, "upper limit for search frequency"),
    "-A": ("fA", float, 0.0, 1.0, "false alarm rate"),
    "--false_alarm": ("fA", float, 0.0, 1.0, "false alarm rate"),
    "--batch": ("batch_size", int, 1, 1 << 16, "batch size"),
    "--mesh": ("mesh_devices", int, 1, 1 << 16, "mesh size"),
}
# options that take a path; a missing value is a file error.  -i and -o
# repeat: the k-th -i and the k-th -o are one pass of the task, searched in
# order in this process (erp_boinc_wrapper.cpp:430-474)
_PAIRED = ("inputfile", "outputfile")
_FILES = {
    "-i": "inputfile", "--input_file": "inputfile",
    "-o": "outputfile", "--output_file": "outputfile",
    "-t": "templatebank", "--template_bank": "templatebank",
    "-c": "checkpointfile", "--checkpoint_file": "checkpointfile",
    "-l": "zaplistfile", "--zaplist_file": "zaplistfile",
    "--status-file": "status_file",
    "--control-file": "control_file",
    "--shmem": "shmem",
    "--profile-dir": "profile_dir",
    "--metrics-file": "metrics_file",
}
_SWITCHES = {
    "-W": ("white", True), "--whitening": ("white", True),
    "-z": ("debug", True), "--debug": ("debug", True),
    "--no-rescore": ("rescore", False),
    "--exact-sin": ("use_lut", False),
}


def _number(flag: str, raw: str, conv, lo, hi, what: str):
    """Parsed value within [lo, hi], or None after reporting the error."""
    try:
        value = conv(raw)
    except ValueError:
        erplog.error('Couldn\'t parse value "%s" for option "%s".\n', raw, flag)
        return None
    if value < lo or value > hi:
        erplog.error("Nonsense value: %s %g outside [%g, %g].\n", what, value, lo, hi)
        return None
    return value


def parse_args(argv: list[str]) -> DriverArgs | int:
    """Returns DriverArgs, or an int exit code on error/help.  The
    task's passes are ``DriverArgs.pairs``; ``inputfile`` and
    ``outputfile`` name the first."""
    kw: dict = {}
    paired: dict = {k: [] for k in _PAIRED}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(_USAGE.format(prog="python -m boinc_app_eah_brp_tpu_torch"))
            return RADPUL_EMISC
        if a in _SWITCHES:
            key, value = _SWITCHES[a]
            kw[key] = value
            if key == "debug":
                erplog.debug("Running program in debugging mode.\n")
            i += 1
            continue
        if a not in _NUMBERS and a not in _FILES and a not in ("-D", "--device"):
            erplog.error('\nUnknown option "%s". Use \'--help\'.\n\n', a)
            return RADPUL_EMISC
        if i + 1 >= len(argv):
            erplog.error('Missing value for option "%s".\n', a)
            return RADPUL_EFILE if a in _FILES else RADPUL_EVAL
        raw = argv[i + 1]
        i += 2
        if a in _FILES:
            if _FILES[a] == "inputfile" and ".binary" not in raw and ".bin4" not in raw:
                erplog.error("Unknown file format (extension) for input file: %s\n", raw)
                return RADPUL_EFILE
            if _FILES[a] in paired:
                paired[_FILES[a]].append(raw)
            else:
                kw[_FILES[a]] = raw
        elif a == "-D":
            if not raw.isdigit():
                erplog.error("Invalid CUDA device ID encountered: %s\n", raw)
                return RADPUL_EVAL
            kw["device"] = f"cuda:{int(raw)}"
        elif a == "--device":
            kw["device"] = raw
        else:
            key, conv, lo, hi, what = _NUMBERS[a]
            value = _number(a, raw, conv, lo, hi, what)
            if value is None:
                return RADPUL_EVAL
            kw[key] = value
    for req in ("inputfile", "outputfile", "templatebank"):
        if req not in kw and not paired.get(req):
            erplog.error("Missing required option for %s.\n", req)
            return RADPUL_EVAL
    inputs, outputs = paired["inputfile"], paired["outputfile"]
    if len(inputs) != len(outputs):
        erplog.error("Need matching -i/-o pairs (got %d inputs, %d outputs).\n", len(inputs), len(outputs))
        return RADPUL_EVAL
    kw.update(inputfile=inputs[0], outputfile=outputs[0], pairs=tuple(zip(inputs, outputs)))
    if kw.get("mesh_devices", 1) > 1 and kw.get("device", "cuda").startswith("cuda:"):
        erplog.error("-D/--device and --mesh N>1 are mutually exclusive.\n")
        return RADPUL_EVAL
    return DriverArgs(**kw)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # --supervised N: this process becomes the restart supervisor, and the
    # worker runs as a child re-exec'd without the flag while the
    # watchdog's temporary exit (rc 99) asks for another pass
    from .supervise import run_supervised, self_cmd, strip_supervised_flag

    worker_argv, restart_budget = strip_supervised_flag(argv)
    if restart_budget is not None:
        return run_supervised(self_cmd(worker_argv), max_restarts=max(0, restart_budget))
    parsed = parse_args(argv)
    if isinstance(parsed, int):
        return parsed
    from .resilience import is_oom

    # Exit-code contract with the native wrapper (native/erp_wrapper.cpp):
    # 1 (RADPUL_EMEM) means out of memory and earns a temporary-exit
    # retry, so no other failure may leak CPython's generic status 1; an
    # out-of-memory the degradation ladder could not absorb ends here
    try:
        return run_search(parsed)
    except Exception as e:
        if is_oom(e):
            erplog.error("Out of memory: %s\n", e)
            return RADPUL_EMEM
        import traceback

        traceback.print_exc()
        erplog.error("Unhandled error: %s\n", e)
        return RADPUL_EMISC
