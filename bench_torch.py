#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: pixels/s a card, forward +
backward, 1M Gaussians at 1080p (gsplat_tpu_torch/tools/bench.py, which says
what it measures and prints).

    python3 bench_torch.py                  # on the card; builds the kernels first
    python3 bench_torch.py --device cpu     # a smoke run of the plain versions
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from gsplat_tpu_torch.tools import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main())
