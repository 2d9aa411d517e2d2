#!/usr/bin/env python3
"""Run one cell with its configuration's control in the program's place.

    python3 loadbench/control.py --workload <cell> --seed <n> --seconds <s>

The control is the program with the lower-precision path that the
configuration names under ``control`` switched on (int8 weights for a bf16
configuration, int4 for an int8 one), judged against the cell's own plain
reference and limits.  Its ``correct`` has to come out false; its
``mean_logit_gap`` is the upper reading a cell's limit is set below.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(control=True))
