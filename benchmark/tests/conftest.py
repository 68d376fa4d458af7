"""The benchmark's folder and the repository's root on the import path, as
``benchmark/run.py`` puts them."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# Several test workers share the machine's cores.
torch.set_num_threads(2)
