"""Output parity of the PyTorch port against the reference's committed mp4s,
in one command.

Port of scripts/parity_pipeline.py: runs the workloads whose outputs the
reference repository committed (``generated_videos/``: i2v RGB "Dog ..."
and i2v sketch "Lion ...", seed 76739) on the port's runtime, scores PSNR
and SSIM against them (``motionclone_tpu_torch/pipeline/parity.py``) and
prints ONE JSON line; it exits 0 when every generated video had a
reference of its name.

    python3 scripts/torch_parity_pipeline.py --reference-outputs DIR
        [--output-dir parity_outputs] [--config-root .]
        [--pretrained-model-path models/StableDiffusion]
        [--workloads rgb,sketch] [--attention-impl auto] [--device cuda]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reference-outputs", required=True,
                   help="directory of the reference's committed sample mp4s")
    p.add_argument("--output-dir", default="parity_outputs")
    p.add_argument("--config-root", default=".")
    p.add_argument("--pretrained-model-path", default="models/StableDiffusion")
    p.add_argument("--workloads", default="rgb,sketch", help="comma-separated subset")
    p.add_argument("--attention-impl", default="auto")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from motionclone_tpu_torch.pipeline.parity import run_parity

    summary = run_parity(args.reference_outputs, args.output_dir,
                         config_root=args.config_root,
                         pretrained_model_path=args.pretrained_model_path,
                         workloads=tuple(args.workloads.split(",")),
                         attention_impl=args.attention_impl, device=args.device)
    print(json.dumps(summary))
    return 0 if summary["matched"] == summary["generated"] else 1


if __name__ == "__main__":
    sys.exit(main())
