"""Command line of the port: the reference's flags that this slice honours
(``demod_binary.c:217-445``), with the same range checks and exit codes,
plus ``--batch`` and ``--device``.  Reference flags the port does not
honour yet are refused with a message that says so."""

from __future__ import annotations

import sys

from .driver import DriverArgs, run_search
from .errors import RADPUL_EFILE, RADPUL_EMEM, RADPUL_EMISC, RADPUL_EVAL

_USAGE = """
Usage: {prog} [options], options are:

 -h, --help\t\t\tboolean\tPrint this message
 -i, --input_file\t\tstring\tThe name of the input file.
 -o, --output_file\t\tstring\tThe name of the candidate output file.
 -t, --template_bank\t\tstring\tThe name of the random template bank.
 -l, --zaplist_file\t\tstring\tThe name of the zaplist file.
 -f, --f0\t\t\tfloat\tThe maximum signal frequency (in Hz)
 -A, --false_alarm\t\tfloat\tFalse alarm probability.
 -P, --padding\t\t\tfloat\tThe frequency over-resolution factor.
 -W, --whitening\t\tboolean\tSwitch for power spectrum whitening and line zapping (required).
 -B, --box\t\t\tint\tWindow width for the running median in frequeny bins.
 --batch\t\t\tint\tTemplates per device batch (default 16).
 --device\t\t\tstring\tTorch device: cuda (default), cuda:N or cpu.
"""

# reference flags this slice refuses, with what they would need
_NOT_YET = {
    "-c": "checkpointing",
    "--checkpoint_file": "checkpointing",
    "-D": "device ordinals (use --device cuda:N)",
    "-z": "debug mode",
    "--debug": "debug mode",
    "--rescore": "oracle rescoring",
    "--mesh": "multi-device search",
    "--exact-sin": "the exact-sine resampler",
    "--status-file": "the BOINC wrapper protocol",
    "--control-file": "the BOINC wrapper protocol",
    "--shmem": "the screensaver shared memory",
    "--supervised": "supervised restarts",
    "--profile-dir": "profiler traces",
    "--metrics-file": "the metrics stream",
}


def _number(flag: str, raw: str, conv, lo, hi, what: str):
    """Parsed value within [lo, hi], or None after reporting the error."""
    try:
        value = conv(raw)
    except ValueError:
        sys.stderr.write(f'Couldn\'t parse value "{raw}" for option "{flag}".\n')
        return None
    if value < lo or value > hi:
        sys.stderr.write(f"Nonsense value: {what} {value:g} outside [{lo:g}, {hi:g}].\n")
        return None
    return value


def parse_args(argv: list[str]) -> DriverArgs | int:
    """Returns DriverArgs, or an int exit code on error/help."""
    kw: dict = {}
    numbers = {
        "-P": ("padding", float, 1.0, 10.0, "padding factor"),
        "--padding": ("padding", float, 1.0, 10.0, "padding factor"),
        "-B": ("window", int, 2, 250000, "window size for running median"),
        "--box": ("window", int, 2, 250000, "window size for running median"),
        "-f": ("f0", float, 0.0, 16.0e3, "upper limit for search frequency"),
        "--f0": ("f0", float, 0.0, 16.0e3, "upper limit for search frequency"),
        "-A": ("fA", float, 0.0, 1.0, "false alarm rate"),
        "--false_alarm": ("fA", float, 0.0, 1.0, "false alarm rate"),
        "--batch": ("batch_size", int, 1, 1 << 16, "batch size"),
    }
    files = {
        "-i": "inputfile", "--input_file": "inputfile",
        "-o": "outputfile", "--output_file": "outputfile",
        "-t": "templatebank", "--template_bank": "templatebank",
        "-l": "zaplistfile", "--zaplist_file": "zaplistfile",
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(_USAGE.format(prog="python -m boinc_app_eah_brp_tpu_torch"))
            return RADPUL_EMISC
        if a in ("-W", "--whitening"):
            kw["white"] = True
            i += 1
            continue
        if a in _NOT_YET:
            sys.stderr.write(
                f'Option "{a}" ({_NOT_YET[a]}) is not supported by the PyTorch port yet.\n'
            )
            return RADPUL_EMISC
        if a not in numbers and a not in files and a != "--device":
            sys.stderr.write(f'\nUnknown option "{a}". Use \'--help\'.\n\n')
            return RADPUL_EMISC
        if i + 1 >= len(argv):
            sys.stderr.write(f'Missing value for option "{a}".\n')
            return RADPUL_EFILE if a in files else RADPUL_EVAL
        raw = argv[i + 1]
        i += 2
        if a in files:
            if files[a] == "inputfile" and ".binary" not in raw and ".bin4" not in raw:
                sys.stderr.write(f"Unknown file format (extension) for input file: {raw}\n")
                return RADPUL_EFILE
            kw[files[a]] = raw
        elif a == "--device":
            kw["device"] = raw
        else:
            key, conv, lo, hi, what = numbers[a]
            value = _number(a, raw, conv, lo, hi, what)
            if value is None:
                return RADPUL_EVAL
            kw[key] = value
    for req in ("inputfile", "outputfile", "templatebank"):
        if req not in kw:
            sys.stderr.write(f"Missing required option for {req}.\n")
            return RADPUL_EVAL
    return DriverArgs(**kw)


def main(argv: list[str] | None = None) -> int:
    parsed = parse_args(sys.argv[1:] if argv is None else argv)
    if isinstance(parsed, int):
        return parsed
    import torch

    try:
        return run_search(parsed)
    except (MemoryError, torch.cuda.OutOfMemoryError) as e:
        sys.stderr.write(f"Out of memory: {e}\n")
        return RADPUL_EMEM
    except Exception as e:  # never leak CPython's generic status 1 (= out of memory)
        import traceback

        traceback.print_exc()
        sys.stderr.write(f"Unhandled error: {e}\n")
        return RADPUL_EMISC
