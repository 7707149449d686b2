"""Runs one cell of the port's benchmark once and prints its result line:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The checkout's root goes first on the module path, so that ``portbench``
and the program under test import from the checkout this file lies in.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
