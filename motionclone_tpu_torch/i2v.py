"""``python3 -m motionclone_tpu_torch.i2v``: the port's i2v command line
(:func:`motionclone_tpu_torch.cli.i2v_main`, SparseCtrl conditioning)."""

from motionclone_tpu_torch.cli import i2v_main

if __name__ == "__main__":
    i2v_main()
