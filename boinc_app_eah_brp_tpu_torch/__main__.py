import sys

from .runtime import tracing

# the command line's own modules: the first span of the process's start
with tracing.span("import"):
    from .runtime.cli import main

sys.exit(main())
