import sys

from .runtime.cli import main

sys.exit(main())
