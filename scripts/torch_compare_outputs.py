"""Score generated videos against reference outputs (PSNR and SSIM) with the
PyTorch port's metrics.

Port of scripts/compare_outputs.py: compares the port's mp4s with the
reference repository's committed sample outputs (or any two videos).

    python3 scripts/torch_compare_outputs.py ours.mp4 theirs.mp4
    python3 scripts/torch_compare_outputs.py ours_dir/ theirs_dir/   # pairs by name

Prints one JSON line per pair: {"pair", "psnr_mean", "ssim_mean", ...}.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from motionclone_tpu_torch.utils.metrics import compare_videos  # noqa: E402


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv
    if os.path.isdir(a) and os.path.isdir(b):
        names = sorted(set(os.listdir(a)) & set(os.listdir(b)))
        pairs = [(os.path.join(a, n), os.path.join(b, n)) for n in names if n.endswith(".mp4")]
        if not pairs:
            print("no common .mp4 names between the two directories", file=sys.stderr)
            return 1
    else:
        pairs = [(a, b)]
    for pa, pb in pairs:
        m = compare_videos(pa, pb)
        m["pair"] = f"{os.path.basename(pa)} vs {os.path.basename(pb)}"
        print(json.dumps(m))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
