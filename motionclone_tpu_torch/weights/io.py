"""State-dict file readers: safetensors and torch pickle checkpoints.

Port of ``motionclone_tpu/weights/io.py``.  Safetensors files are read by
the port's own reader (no ``safetensors`` package): an 8-byte little-endian
header length, a JSON header naming each tensor's dtype, shape and byte
range, then the data, read with ``numpy.frombuffer`` over one ``mmap``.
``.ckpt/.pt/.pth/.bin`` files go through ``torch.load(weights_only=True)``.
Tensors keep their stored dtype (bf16 included).  A missing file raises;
nothing is downloaded.  :func:`save_safetensors` writes the same format.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype)
_ST_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),  # stored bits, viewed as bf16
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "U8": (np.dtype("u1"), torch.uint8),
    "BOOL": (np.dtype("?"), torch.bool),
}


_ST_NAMES = {torch_dtype: name for name, (_, torch_dtype) in _ST_DTYPES.items()}


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write ``tensors`` as a ``.safetensors`` file: the header (each
    tensor's dtype, shape and byte range; padded with spaces to a multiple
    of 8 bytes), then each tensor's bytes, C-contiguous, with no gap.  The
    tensors are laid out widest element first, so every tensor starts at a
    multiple of its element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {t.dtype} "
                             f"(supported: {sorted(_ST_DTYPES)})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for name in order:
            flat = tensors[name].detach().cpu().contiguous().reshape(-1)
            f.write(flat.view(torch.uint8).numpy().data)


def load_safetensors(path: str) -> StateDict:
    """Every tensor of a ``.safetensors`` file, in its stored dtype."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            (n,) = struct.unpack("<Q", mm[:8])
            if 8 + n > size:
                raise ValueError(f"{path}: header length {n} runs past the end of the file")
            header = json.loads(bytes(mm[8:8 + n]).decode("utf-8"))
            base = 8 + n
            out: StateDict = {}
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                if info["dtype"] not in _ST_DTYPES:
                    raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                                     f"{info['dtype']} (supported: {sorted(_ST_DTYPES)})")
                np_dtype, torch_dtype = _ST_DTYPES[info["dtype"]]
                shape = tuple(int(d) for d in info["shape"])
                begin, end = (int(x) for x in info["data_offsets"])
                count = int(np.prod(shape, dtype=np.int64))
                if end - begin != count * np_dtype.itemsize or base + end > size:
                    raise ValueError(f"{path}: tensor {name!r} byte range [{begin}, {end}) "
                                     f"does not hold {info['dtype']} {list(shape)}")
                tensor = _copy_out(mm, np_dtype, count, base + begin, shape)
                out[name] = tensor.view(torch_dtype) if torch_dtype == torch.bfloat16 else tensor
            return out


def _copy_out(mm: mmap.mmap, np_dtype: np.dtype, count: int, offset: int, shape
              ) -> torch.Tensor:
    """A tensor holding a copy of ``count`` elements at ``offset``: the view
    into the map ends here, so that the map can close."""
    view = np.frombuffer(mm, dtype=np_dtype, count=count, offset=offset)
    return torch.from_numpy(view.reshape(shape).copy())


def load_state_dict(path: str) -> StateDict:
    """A checkpoint file as a flat {key: tensor} dict on the CPU.  Pickles
    wrapping their weights in ``state_dict`` are unwrapped; entries that are
    not tensors (training metadata) are left out."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}
