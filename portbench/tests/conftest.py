"""Import paths for the benchmark's tests: the program under ``src`` and
the benchmark's own packages (``harness``, ``reference``). No test here
needs a card: each drives the harness and the reference on the CPU."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
