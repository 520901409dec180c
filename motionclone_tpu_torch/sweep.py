"""``python3 -m motionclone_tpu_torch.sweep``: the port's sweep command line
(:func:`motionclone_tpu_torch.cli.sweep_main`: examples batched on one
card, or share-nothing ranks under torchrun with ``--distributed``)."""

from motionclone_tpu_torch.cli import sweep_main

if __name__ == "__main__":
    sweep_main()
