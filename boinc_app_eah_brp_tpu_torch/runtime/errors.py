"""Exit/error codes matching the reference (``demod_binary.h:24-73``)."""

RADPUL_EMEM = 1
RADPUL_EFILE = 2
RADPUL_EIO = 3
RADPUL_EVAL = 4
RADPUL_EMISC = 5


class RadpulError(RuntimeError):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
