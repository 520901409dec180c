"""Time one phase-2 check of two checkouts on one H100, in turns.

    python3 scripts/torch_resnet_ab.py OTHER_CHECKOUT [--check resnet] [--rounds 1]

Runs one phase-2 check of ``chip_smoke.py`` (each kernel at every
main-path shape against its plain version, with its times) from
OTHER_CHECKOUT (for example the parent commit, unpacked with ``git
archive`` into a directory ``.gitignore`` lists) and from this checkout,
each in a process of its own that builds its own kernels, in the order
other, this, this, other (per round), so that both are timed on one card
in one session.  ``--check``:

- ``resnet``: kernel 8 (``check_resnet_kernels``; a checkout that predates
  it runs its ``check_fused_kernels`` with the other fused modules' shapes
  left out);
- ``temporal``: kernels 3, 4, 3r and 4r (``check_temporal_kernels``; a
  checkout that predates it runs its ``check_kernels``, the flash kernels'
  check included);
- ``temporal-device``: kernels 3, 4, 3r and 4r at every main-path shape,
  timed through their C entry points (at S = 64 and 256 a call of the
  Python wrapper takes longer on the host than the kernel on the card);
- ``fused``: kernels 5-7 (``check_fused_kernels``).

Each run is this script again (``--run CHECK``) with the checkout as its
working directory and first on ``sys.path``, so that it imports that
checkout's ``chip_smoke`` and port.

Prints each run's kernel lines under a header naming the checkout; exits
non-zero without a card or if a run fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHECKS = ("resnet", "temporal", "temporal-device", "fused")


def temporal_device_times(cs, dev) -> None:
    """Kernels 3, 4, 3r and 4r at every main-path (S, head dim), B = 1 and
    2, and 16, 8, 4 and 2 query frames, launched through the checkout's C
    entry points (``mc_temporal_fwd``, ``mc_temporal_bwd``: no Python
    checks per launch) and timed with CUDA events, so that at the small
    shapes the time is the device's and not the host's enqueue time."""
    import torch

    from motionclone_tpu_torch.ops import build as kb
    from motionclone_tpu_torch.ops import temporal_attention as ta

    lib = kb.load_library()
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    for s, d in cs.ATTN_SHAPES:
        hd, scale = cs.HEADS * d, d ** -0.5
        for fq in (16, *cs.RECT_QUERY_FRAMES):
            for b in (1, 2):
                q, dout = randn(b, fq, s, hd), randn(b, fq, s, hd)
                k, v = randn(b, 16, s, hd), randn(b, 16, s, hd)
                out, lse = ta.temporal_fwd_rect(q, k, v, cs.HEADS, scale) if fq != 16 else \
                    ta.temporal_fwd(q, k, v, cs.HEADS, scale)
                dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                dims = (b, fq, 16, s, cs.HEADS, d, scale, stream)
                fwd = lambda: lib.mc_temporal_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                  out.data_ptr(), lse.data_ptr(), *dims)
                bwd = lambda: lib.mc_temporal_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims)
                rect = "_rect" if fq != 16 else ""
                for name, fn in ((f"temporal_fwd{rect}", fwd), (f"temporal_bwd{rect}", bwd)):
                    kb.check(fn(), name)
                    print(f"kernel {name:17s} shape={(b, fq, s, hd)} C entry "
                          f"kernel_ms={cs.time_ms(fn, reps=50, warmup=5):.4f}", flush=True)


def run_check(check: str) -> None:
    """One check of the checkout whose root is the working directory."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if check == "resnet" and hasattr(cs, "check_resnet_kernels"):
        cs.check_resnet_kernels(dev)
    elif check == "resnet":
        cs.FUSED_SHAPES = ()
        cs.check_fused_kernels(dev)
    elif check == "temporal" and hasattr(cs, "check_temporal_kernels"):
        cs.check_temporal_kernels(dev)
    elif check == "temporal":
        cs.check_kernels(dev)
    elif check == "temporal-device":
        temporal_device_times(cs, dev)
    else:
        cs.check_fused_kernels(dev)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", nargs="?", help="the other checkout's root directory")
    parser.add_argument("--check", choices=CHECKS, default="resnet")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--run", choices=CHECKS, help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_resnet_ab: CUDA is not available", file=sys.stderr)
        return 1
    if args.run:  # a child process: the check, in its checkout
        run_check(args.run)
        return 0
    if args.other is None:
        parser.error("the other checkout's root directory is required")
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for name, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
            print(f"== {name}: {root}", flush=True)
            proc = subprocess.run([sys.executable, __file__, "--run", args.check], cwd=root,
                                  env=dict(os.environ, PYTHONPATH=str(root)))
            if proc.returncode:
                print(f"torch_resnet_ab: the run in {root} failed ({proc.returncode})",
                      file=sys.stderr)
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
