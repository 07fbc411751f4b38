"""The benchmark's command: one run of one cell on this machine's card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``harness.py``.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
