"""The harness's CPU tests: the repository's root on the import path, so
that `pytest hbench/tests` finds the harness and the program from anywhere."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
