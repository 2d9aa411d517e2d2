#!/usr/bin/env python3
"""Time the PyTorch port's kernels of one source tree at chip_smoke.py's shapes.

    python3 scripts/torch_kernel_times.py [--tree DIR] [--label NAME] [--kernel NAME ...]

Imports ``calfkit_tpu_torch`` from ``DIR`` (default: this checkout), builds
its kernels, and runs THIS checkout's ``chip_smoke.py`` kernel phase against
them, for the kernels the tree has (or those ``--kernel`` names): every
kernel against its plain version,
timed with CUDA events beside the plain version,
``scaled_dot_product_attention`` and the bound.
Two trees (e.g. a parent commit unpacked with ``git archive`` into a
git-ignored directory) are thus timed by the same code: run parent, change,
change, parent in one call to compare them on one card.  Prints one JSON
line: the card's name and power limit, the label and every case.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose kernels to time")
    parser.add_argument("--label", default="", help="a name for this tree in the output")
    parser.add_argument("--kernel", action="append", default=[],
                        help="time only this kernel's cases (repeatable; default: all)")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    import calfkit_tpu_torch  # noqa: F401 - from --tree; chip_smoke's imports bind to it

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py: f32 in full f32
    torch.backends.cudnn.allow_tf32 = False
    smoke.kernels.build_all()
    # a tree of an earlier slice lacks the later kernels: time what it has
    plan = [case for case in smoke.kernel_plan() if hasattr(smoke.A, case[0])
            and (not args.kernel or case[0] in args.kernel)]
    with contextlib.redirect_stdout(sys.stderr):  # the per-case lines; stdout keeps the JSON
        cases = smoke.run_cases(torch.device("cuda", 0), plan)
    print(json.dumps(dict(
        card=smoke.card_line(), label=args.label, tree=str(Path(args.tree).resolve()),
        cases=cases,
    ), default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
