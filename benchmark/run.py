"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload palfa6662.search --seed 7 --seconds 10 --trace 0

See README.md in this folder."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bmlib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
