"""The benchmark's tests import ``benchmark`` and the program from the
repository's root, wherever pytest was started."""
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
