"""Host-side syntax check of the port's CUDA sources, for a machine with no nvcc.

    python3 scripts/cuda_syntax_check.py [file.cu ...]   # default: every csrc/*.cu

Each source and the headers beside it are copied to a temporary directory
with their kernel launches (``<<<...>>>``) stripped, and compiled by
``g++ -fsyntax-only`` against stub CUDA headers that make ``__global__``,
``__device__`` and the like empty and declare the intrinsics the sources
use.  That finds C++ errors (names, namespaces, templates, types) before a
build on the card; it checks no PTX, no inline-assembly operand and no
register count.  Exits non-zero if any source fails.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "motionclone_tpu_torch" / "csrc"

CUDA_RUNTIME = r"""
#pragma once
#include <cstdint>
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__
#define __grid_constant__
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3v { unsigned x, y, z; };
extern uint3v threadIdx, blockIdx, blockDim, gridDim;
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> int cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaDeviceSynchronize() { return 0; }
#define CUDART_VERSION 12080
enum cudaError_t { cudaSuccess = 0 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess };
enum { cudaEnableDefault = 0 };
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
cudaError_t cudaGetDriverEntryPoint(const char*, void**, unsigned long long,
                                    cudaDriverEntryPointQueryResult*);
cudaError_t cudaGetDriverEntryPointByVersion(const char*, void**, unsigned int,
                                             unsigned long long,
                                             cudaDriverEntryPointQueryResult*);
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
float __uint_as_float(unsigned);
void __trap();
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
size_t __cvta_generic_to_shared(const void*);
template <class T> T __shfl_xor_sync(unsigned, T, int);
template <class T> T __shfl_sync(unsigned, T, int);
void __syncthreads();
void __syncwarp(unsigned = 0xffffffffu);
float __expf(float);
float __fdividef(float, float);
float rsqrtf(float);
float erff(float);
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long min(long a, long b) { return a < b ? a : b; }
"""

CUDA_DRIVER = r"""
#pragma once
#include <cstdint>
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
enum CUresult { CUDA_SUCCESS = 0 };
struct CUtensorMap { alignas(64) cuuint64_t opaque[16]; };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_256B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };
"""

CUDA_BF16 = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
__nv_bfloat162 __floats2bfloat162_rn(float, float);
float __bfloat162float(__nv_bfloat16);
float2 __bfloat1622float2(__nv_bfloat162);
unsigned short __bfloat16_as_ushort(__nv_bfloat16);
__nv_bfloat16 __float2bfloat16(float);
"""


def main(argv) -> int:
    sources = [Path(a).resolve() for a in argv] or sorted(CSRC.glob("*.cu"))
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        stub = Path(tmp) / "stub"
        stub.mkdir()
        (stub / "cuda_runtime.h").write_text(CUDA_RUNTIME)
        (stub / "cuda_bf16.h").write_text(CUDA_BF16)
        (stub / "cuda.h").write_text(CUDA_DRIVER)
        for src in sources:
            # the source's directory and csrc/, at their places under the
            # repository root, so that relative includes resolve
            for d in {src.parent, CSRC}:
                work = Path(tmp) / "root" / d.relative_to(ROOT)
                work.mkdir(parents=True, exist_ok=True)
                for f in d.glob("*.cu*"):
                    text = re.sub(r"<<<.*?>>>", "", f.read_text(), flags=re.S)
                    (work / f.name).write_text(text)
            r = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-x", "c++",
                                "-I", str(stub),
                                str(Path(tmp) / "root" / src.relative_to(ROOT))],
                               capture_output=True, text=True)
            print(f"{src.name}: {'OK' if r.returncode == 0 else 'FAIL'}")
            if r.returncode:
                bad = 1
                print("\n".join(l for l in r.stderr.splitlines() if "error" in l)[:4000])
    return bad


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
