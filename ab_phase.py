#!/usr/bin/env python3
"""Run one phase of ``chip_smoke.py`` for two checkouts in turns on one GPU.

    python3 ab_phase.py slice OLD_DIR NEW_DIR     # OLD, NEW, NEW, OLD
    python3 ab_phase.py build,read_kernels OLD_DIR NEW_DIR

The host's eager work sets the port's end-to-end times, and hosts differ
from one machine to the next, so two trees are compared only within one
run on one host. Each turn is a process of its own in the checkout's
directory: it imports that checkout's ``chip_smoke.py``, runs its device
phase and the named phases in order (``slice``, ``train``, ...; each
builds the kernels it launches at first use; ``build`` first for a part
of the kernels phase, such as ``read_kernels``, which reads the operation
counters it builds), and its output follows a line ``== turn i: DIR``.
Exits 1 if any turn failed.
"""

import os
import subprocess
import sys

TURN = """
import sys, torch, chip_smoke
s = chip_smoke.Smoke()
s.phase("device", s.device)
for name in sys.argv[1].split(","):
    if not s.failed:
        dev = () if name == "build" else (torch.device("cuda", 0),)
        s.phase(name, getattr(s, name), *dev)
sys.exit(1 if s.failed else 0)
"""


def main() -> int:
    if len(sys.argv) != 4:
        print(__doc__, file=sys.stderr)
        return 2
    phase, old, new = sys.argv[1:]
    failed = 0
    for i, tree in enumerate((old, new, new, old)):
        print(f"== turn {i}: {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", TURN, phase],
                              cwd=os.path.abspath(tree), timeout=1800)
        failed |= proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
