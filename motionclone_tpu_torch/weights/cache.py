"""Converted-weights cache: skip checkpoint assembly on a warm start.

Port of ``motionclone_tpu/weights/cache.py``.  The state dicts that the
loader hands to the modules (after assembly, the DreamBooth and
motion-module merges and the LoRA merge, in the run's dtype) are kept as
one safetensors file per unique set of sources and read back on later
starts.  An entry is keyed by every source file's (path, size, mtime), the
merge knobs and the port's own converter sources (this package's
``weights/*.py``), so editing a checkpoint, a LoRA, a config or the
converter misses the old entry.  Entries are named ``params-torch-<key>``,
apart from the JAX package's ``params-<key>`` in a shared directory, and
written atomically (a temporary file, then a rename), so concurrent runs
can share a directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Mapping, Optional, Sequence

import torch

from motionclone_tpu_torch.weights.io import load_safetensors, save_safetensors

StateDict = Dict[str, torch.Tensor]

_SEP = "::"  # component / parameter-key separator inside the file
_ORPHAN_AGE_S = 3600.0  # a temporary file older than this was left by a crash


def _stat_entry(path: str):
    """(path, size, mtime_ns) of a source; a missing file records as
    (path, None), so that a file appearing later also misses."""
    if not path:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return [path, None]
    return [path, st.st_size, st.st_mtime_ns]


def _converter_fingerprint():
    """The stat entries of the port's converter sources (``weights/*.py``):
    a change to any of them misses every earlier entry."""
    here = os.path.dirname(os.path.abspath(__file__))
    return [_stat_entry(os.path.join(here, f)) for f in sorted(os.listdir(here))
            if f.endswith(".py")]


def cache_key(source_paths: Sequence[str], knobs: Mapping[str, object]) -> str:
    """The key of an entry: every file whose bytes feed the weights, the
    knobs that are not files (dtype name, merge scales) and the converter's
    own sources."""
    payload = json.dumps([[_stat_entry(p) for p in source_paths], dict(sorted(knobs.items())),
                          _converter_fingerprint()], sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def _entry_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"params-torch-{key}.safetensors")


def save_params(cache_dir: str, key: str,
                state_dicts: Mapping[str, Optional[Mapping[str, torch.Tensor]]]) -> str:
    """Write ``{component: state_dict}`` (None components skipped) as the
    entry of ``key``, atomically; returns its path.  Temporary files that a
    crashed run left behind (older than an hour) are removed first; a
    younger one may be a concurrent run's."""
    os.makedirs(cache_dir, exist_ok=True)
    for name in os.listdir(cache_dir):
        if ".safetensors.tmp." in name:
            p = os.path.join(cache_dir, name)
            try:
                if time.time() - os.path.getmtime(p) > _ORPHAN_AGE_S:
                    os.remove(p)
            except OSError:
                pass
    flat = {}
    for comp, sd in state_dicts.items():
        if sd is None:
            continue
        if _SEP in comp:
            raise ValueError(f"component name may not contain {_SEP!r}: {comp}")
        for k, v in sd.items():
            flat[f"{comp}{_SEP}{k}"] = v.detach().cpu().contiguous()
    path = _entry_path(cache_dir, key)
    tmp = f"{path}.tmp.{os.getpid()}"
    save_safetensors(tmp, flat)
    os.replace(tmp, path)
    return path


def load_params(cache_dir: str, key: str) -> Optional[Dict[str, StateDict]]:
    """The entry of ``key`` as ``{component: state_dict}``, or None on a
    miss: no entry, or one that does not read (a corrupt file is a miss,
    the caller converts again)."""
    path = _entry_path(cache_dir, key)
    if not os.path.exists(path):
        return None
    try:
        flat = load_safetensors(path)
    except (OSError, ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None
    out: Dict[str, StateDict] = {}
    for fk, v in flat.items():
        comp, sep, k = fk.partition(_SEP)
        if not sep:
            return None
        out.setdefault(comp, {})[k] = v
    return out
