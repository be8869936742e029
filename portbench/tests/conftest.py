"""portbench's own tests: the checkout's root on sys.path, so that
`portbench` and the program import as packages."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
