"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), linked into one shared library
with a plain C interface, and loaded with ``ctypes``.  The library's name
carries a hash of the sources, the headers they share (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds and an unchanged tree is
reused.  The build goes to ``build/`` at the repository
root, which ``.gitignore`` lists.

Nothing here runs at import: the first kernel launch calls
:func:`load_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of the C entry points (csrc/*.cu, ``extern "C"``)
SIGNATURES = {
    "mc_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "mc_flash_bwd": (_P,) * 10 + (_I, _I, _I, _I, _I, _F, _P),
    "mc_flash_smem": (_I, _I),
    "mc_temporal_fwd": (_P,) * 5 + (_I,) * 6 + (_F, _P),
    "mc_temporal_bwd": (_P,) * 8 + (_I,) * 6 + (_F, _P),
    "mc_temporal_smem": (_I, _I, _I),
    # the fused modules: (pointer array, int array of dims, eps, stream)
    "mc_fused_resnet_block": (_P, _P, _F, _P),
    "mc_fused_temporal_module": (_P, _P, _F, _P),
    "mc_fused_spatial_transformer": (_P, _P, _F, _P),
    "mc_fused_transformer_block": (_P, _P, _F, _P),
    # the fused modules' product alone, and the resnet's convolution alone:
    # (pointer array, dims array, stream)
    "mc_fused_product": (_P, _P, _P),
    "mc_conv3x3": (_P, _P, _P),
    "mc_fused_product_smem": (_I,),
    # the differentiable GroupNorm (+ SiLU): (pointer array, dims array[, eps], stream)
    "mc_group_norm_fwd": (_P, _P, _F, _P),
    "mc_group_norm_bwd": (_P, _P, _P),
}

_library: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked under $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def _digest(csrc: Path) -> str:
    """Hash of the flags and of every source and header under ``csrc``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/libmotionclone_kernels_<hash>.so``
    unless that file exists; return its path.  Raises with the compiler's
    output if any source fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    lib = BUILD_DIR / f"libmotionclone_kernels_{_digest(CSRC_DIR)}.so"
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # objects in a private directory, the library renamed into place: two
    # processes building at once never see each other's partial files
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        outs = [proc.communicate()[0] for proc in procs]
        log = "\n".join(f"== {src.name}\n{out}" for src, out in zip(sources, outs))
        (BUILD_DIR / f"{lib.stem}.log").write_text(log)
        failed = [src.name for src, proc in zip(sources, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / lib.name
        subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp_lib, lib)
    build_info.update(
        path=str(lib), seconds=time.perf_counter() - t0, cached=False, log=log
    )
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library


# the kernels take their dims, and count rows and elements, in 32-bit ints
# (their pointer offsets are 64-bit): no tensor may hold 2**31 elements
INT32_MAX = 2**31 - 1


def check_extent(*tensors) -> None:
    """Refuse, before a launch, a tensor whose element count a 32-bit int
    cannot hold (a batch of many examples at full size)."""
    for t in tensors:
        if t is not None and t.numel() > INT32_MAX:
            raise ValueError(
                f"a tensor of shape {tuple(t.shape)} holds {t.numel()} elements: the "
                f"kernels count elements in 32-bit ints, so they take at most {INT32_MAX}; "
                f"run fewer examples per pass (--num-devices)")


def pointers(*tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (None for a null pointer),
    the first argument of the fused modules' entry points; checks each
    tensor's extent."""
    check_extent(*tensors)
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors)
    )


def ints(*values: int) -> ctypes.Array:
    """A C array of ints, the dims argument of the fused modules' entry
    points (a value outside int32 raises: ctypes would wrap it)."""
    for v in values:
        if not -INT32_MAX - 1 <= v <= INT32_MAX:
            raise ValueError(f"dim {v} does not fit the kernels' 32-bit ints")
    return (ctypes.c_int * len(values))(*values)


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if status == -1:
        raise ValueError(f"{name}: no kernel for this shape")
    if status == -2:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused an operand "
                           f"(or the CUDA runtime found no such entry point)")
    if status:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
