"""The benchmark's own CPU tests: ``python -m pytest benchmark/tests -q``
from the root of the checkout (the card's test carries the ``cuda``
marker and skips without a card)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
