"""Exit/error codes matching the reference (``demod_binary.h:24-73``), and
the one table that maps a failure to its code."""

RADPUL_EMEM = 1
RADPUL_EFILE = 2
RADPUL_EIO = 3
RADPUL_EVAL = 4
RADPUL_EMISC = 5
# the watchdog's "restart me" exit (runtime/watchdog.py), the analogue of
# boinc_temporary_exit (erp_boinc_wrapper.cpp:560-570): the run is healthy
# enough to be re-run from its last checkpoint, by --supervised or BOINC
RADPUL_TEMPORARY_EXIT = 99


class RadpulError(RuntimeError):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def exit_code_for(e: BaseException) -> int | None:
    """The RADPUL_* code a failure maps to, or None for an exception
    outside the mapped set (which then propagates): an unusable
    checkpoint is a file error, a bad bank or value a validation error,
    and so is a numerical-health abort (``ERP_HEALTH_ACTION=abort``: the
    numbers are wrong), a missing or short file an I/O error."""
    from ..io.checkpoint import CheckpointError
    from ..io.templates import TemplateBankError
    from .health import HealthError

    if isinstance(e, RadpulError):
        return e.code
    if isinstance(e, CheckpointError):
        return RADPUL_EFILE
    if isinstance(e, (TemplateBankError, HealthError, ValueError)):
        return RADPUL_EVAL
    if isinstance(e, (FileNotFoundError, EOFError)):
        return RADPUL_EIO
    return None
