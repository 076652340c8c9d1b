#!/usr/bin/env python3
"""A restarted server's start-up with the AOT tier and without it, on a GPU.

    python3 tools/server_start_torch.py [--pairs 4]

``chip_smoke.py``'s ``aot_server_starts`` with more pairs:
``serve.build_server`` (bf16, 224x224, max_batch 16: five warm-up buckets,
with ``--aot_cache`` each one a CUDA graph capture) on a seeded random
cUNet checkpoint, every start in a young process after one untimed plain
start, so each tiered start holds its process's first captures; ``--pairs``
times two processes, one timing plain then tier and the other tier then
plain.  Prints the card's name and power limit from nvidia-smi, then one
JSON line with every start's seconds and the difference of the medians;
exits 1 when that is above ``chip_smoke.START_BAR_S``.  Needs a CUDA
device; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=4)
    args = p.parse_args(argv)
    if not cs.torch.cuda.is_available():
        raise SystemExit("server_start_torch: no CUDA device is available")
    cs.aot_server_starts(cs.phase_env(), pairs=args.pairs)


if __name__ == "__main__":
    main()
