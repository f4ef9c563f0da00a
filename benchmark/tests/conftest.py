"""The benchmark's CPU tests: run with ``python -m pytest benchmark/tests``
from the checkout's root.  The harness is imported as ``harness``."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
