"""rtbench's CPU tests: the manifest, the arithmetic, the generator,
the import guard, and the comparison at a size the CPU holds.

    python -m pytest rtbench/tests -q

Tests marked `cuda` run one cell on the card and skip without one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
