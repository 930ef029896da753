"""The program's command line in this process, then a look at what it
loaded:

    python program_main.py [--trace TRACE.json] <the command line's arguments>

runs ``python -m boinc_app_eah_brp_tpu_torch <arguments>`` here
(``runpy``); with ``--trace``, under ``torch.profiler`` inside a
``bench.window`` range, the card drained and the Chrome trace written to
TRACE.json.  Then it looks in ``sys.modules`` for JAX or the JAX package
(``bmlib/harness.py::FORBIDDEN``, top-level names compared whole): where
it finds any, it names them on its last line of standard error after
:data:`FOUND` and exits with :data:`FOUND_EXIT`; otherwise with the
command line's code.  The command-line cell runs every child through
it."""

import os
import runpy
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)

from bmlib import harness  # noqa: E402

FOUND = "program_main: loaded "
FOUND_EXIT = 70
PROGRAM = harness.PROGRAM


def _main(argv) -> int:
    trace_path = None
    if argv[:1] == ["--trace"]:
        trace_path, argv = argv[1], argv[2:]
    # the program's path as ``python -m`` gives it: the working directory first
    sys.path[:2] = [os.getcwd()]
    sys.argv = [PROGRAM] + argv
    code = 0

    def program():
        nonlocal code
        try:
            runpy.run_module(PROGRAM, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)

    if trace_path is None:
        program()
    else:
        from bmlib import trace

        trace.capture(program, trace_path)
    found = harness.forbidden_modules()
    if found:
        print(FOUND + ", ".join(found), file=sys.stderr, flush=True)
        return FOUND_EXIT
    return code


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
