"""Time kernel 8 (the fused resnet block) of two checkouts on one H100, in turns.

    python3 scripts/torch_resnet_ab.py OTHER_CHECKOUT [--rounds 1]

Runs kernel 8's phase-2 check of ``chip_smoke.py`` (every main-path shape
against its plain version, timed beside the port's unfused module) from
OTHER_CHECKOUT (for example the parent commit, unpacked with ``git
archive`` into a directory ``.gitignore`` lists) and from this checkout,
each in a process of its own that builds its own kernels, in the order
other, this, this, other (per round), so that both are timed on one card
in one session.  A checkout whose ``chip_smoke.py`` predates
``check_resnet_kernels`` runs its ``check_fused_kernels`` with the other
fused modules' shapes left out.  Prints each run's kernel lines under a
header naming the checkout; exits non-zero without a card or if a run
fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
if hasattr(cs, "check_resnet_kernels"):
    cs.check_resnet_kernels(dev)
else:
    cs.FUSED_SHAPES = ()
    cs.check_fused_kernels(dev)
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="the other checkout's root directory")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_resnet_ab: CUDA is not available", file=sys.stderr)
        return 1
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for name, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
            print(f"== {name}: {root}", flush=True)
            proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                                  env=dict(os.environ, PYTHONPATH=str(root)))
            if proc.returncode:
                print(f"torch_resnet_ab: the run in {root} failed ({proc.returncode})",
                      file=sys.stderr)
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
