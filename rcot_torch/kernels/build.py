"""Build and load the port's CUDA kernels.

Every `rcot_torch/csrc/*.cu` file is compiled with nvcc for sm_90a, each
source by its own nvcc process and all of them at once, then linked into
one shared library with a plain C interface that ctypes loads; the sources
share the headers `csrc/*.cuh`. Nothing is built when a module is imported:
the first kernel launch builds, into `build/kernels/` at the root of the
checkout, under a name that hashes the sources, the headers and the flags,
so a changed source is rebuilt and an unchanged one is loaded as it is.

Each C entry point returns cudaGetLastError() (or the error of a failed
set-up call); `call` raises when it is not 0. Launch counts live in
`LAUNCHES`, one per kernel wrapper, raised by the wrappers exactly where
they launch.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# name -> launches, raised by the wrapper of that kernel
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SIGNATURES = {
    # inputs 5, output 1, workspace 4, plan (ops/block.py); B, H, W, C, M; stream
    "rcot_block_head": [_P] * 10 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # inputs 8, output 1, workspace 6, plan; B, H, W, C, hid; stream
    "rcot_block_tail": [_P] * 15 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # the same two in bf16 (block_fwd_bf16.cu): the same arguments
    "rcot_block_head_bf16": [_P] * 10 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    "rcot_block_tail_bf16": [_P] * 15 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # qkv, G, nq, nk, workspace; B, hw, heads, ch, channel block, splits,
    # pixels per split; stream
    "rcot_mdta_gram": [_P] * 5 + [_I, _L, _I, _I, _I, _I, _L, _P],
    # qkv, attn, out, workspace; B, hw, heads, ch, channel block, blocks,
    # tiles per block; stream
    "rcot_attn_apply": [_P] * 4 + [_I, _L, _I, _I, _I, _I, _L, _P],
    # the same two on a bf16 qkv (gram_bf16.cu): the same arguments and the
    # copy width (ops/gram.py bf16_copy_width) before the stream
    "rcot_mdta_gram_bf16": [_P] * 5 + [_I, _L, _I, _I, _I, _I, _L, _I, _P],
    "rcot_attn_apply_bf16": [_P] * 4 + [_I, _L, _I, _I, _I, _I, _L, _I, _P],
    # inputs 6, outputs 5, workspace 6, plan (ops/block.py); B, H, W, C, M; stream
    "rcot_block_head_bwd": [_P] * 17 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # inputs 9, outputs 8, workspace 9, plan; B, H, W, C, hid; stream
    "rcot_block_tail_bwd": [_P] * 26 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # qkv, dG, dnq, dnk, d[q|k], workspace; B, hw, heads, ch, channel block,
    # blocks, tiles per block; stream
    "rcot_mdta_gram_bwd": [_P] * 6 + [_I, _L, _I, _I, _I, _I, _L, _P],
    # qkv, attn, g, dv, dattn, workspace; B, hw, heads, ch, channel block,
    # splits, pixels per split; stream
    "rcot_attn_apply_bwd": [_P] * 6 + [_I, _L, _I, _I, _I, _I, _L, _P],
    # inputs 3, output 1, workspace 2, plan (ops/fused.py); B, H, W, C, M; stream
    "rcot_conv1x1_dw": [_P] * 6 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # inputs 4, output 1, workspace 3, plan; B, H, W, C, hid; stream
    "rcot_gdfn_fused": [_P] * 8 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # inputs 4, outputs 3, workspace 3, plan; B, H, W, C, M; stream
    "rcot_conv1x1_dw_bwd": [_P] * 10 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # inputs 5, outputs 4, workspace 5, plan; B, H, W, C, hid; stream
    "rcot_gdfn_fused_bwd": [_P] * 14 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # bf16 training (fused_dwconv_bf16.cu, block_bwd_bf16.cu, gram_bwd_bf16.cu):
    # the qkv forward in bf16, the arguments of rcot_conv1x1_dw
    "rcot_conv1x1_dw_bf16": [_P] * 6 + [ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    # inputs 4, outputs 3, workspace 11, plan; bf16 copy width; B, H, W, C, M; stream
    "rcot_conv1x1_dw_bwd_bf16": [_P] * 18 + [ctypes.POINTER(_I)] + [_I] * 6 + [_P],
    # inputs 9, outputs 8, workspace 24, plan, bf16 plan; B, H, W, C, hid; stream
    "rcot_block_tail_bwd_bf16": [_P] * 41 + [ctypes.POINTER(_I)] * 2 + [_I] * 5 + [_P],
    # qkv, dG, dnq, dnk, d[q|k], workspace 3; B, hw, heads, ch, channel block,
    # blocks, tiles per block; stream
    "rcot_mdta_gram_bwd_bf16": [_P] * 8 + [_I, _L, _I, _I, _I, _I, _L, _P],
    # qkv, attn, g, dv, dattn, workspace 4; B, hw, heads, ch, channel block,
    # splits, pixels per split; stream
    "rcot_attn_apply_bwd_bf16": [_P] * 9 + [_I, _L, _I, _I, _I, _I, _L, _P],
    # x, taps, out; B, H, W, C, vec, cv, tc, rows, rot; stream
    "rcot_dwconv3x3": [_P] * 3 + [_I] * 9 + [_P],
    # x, g, workspace, dtaps; B, H, W, C, vec, cv, tc, rows; stream
    "rcot_dwconv3x3_dtaps": [_P] * 4 + [_I] * 8 + [_P],
    # vec, cv, tc, dtaps; -> blocks an SM holds
    "rcot_dwconv3x3_blocks_per_sm": [_I] * 4 + [ctypes.POINTER(_I)],
    # vec, cv, tc, bf16 out; -> blocks an SM holds of the bf16 forward
    "rcot_dwconv3x3_bf16_blocks_per_sm": [_I] * 4 + [ctypes.POINTER(_I)],
    # q, k, v, temperature, out, workspace; BH, heads, c, N; the plan
    # (ops/mdta.py mdta_plan): splits, pixels per split, channel block,
    # apply blocks, tiles per apply block, softmax warps; copy width; stream
    "rcot_mdta_attend": [_P] * 6 + [_I] * 3 + [_L] + [_I] * 7 + [_P],
}


def reset_launches() -> None:
    LAUNCHES.clear()


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    cand = Path(home) / "bin" / "nvcc" if home else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *headers()]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path. The compiler's output, register and shared-memory use included,
    and each source's compile time are kept beside it in build.log."""
    srcs = sources()
    lib = build_dir / f"librcot_kernels_{_digest(srcs)}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs, procs = [], []
        t0 = time.perf_counter()
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            objs.append(obj)
            out = open(Path(tmp) / (s.stem + ".log"), "w+")
            procs.append((s, out, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
                stdout=out, stderr=subprocess.STDOUT, text=True)))
        seconds: dict = {}
        while len(seconds) < len(procs):
            for s, _, p in procs:
                if s not in seconds and p.poll() is not None:
                    seconds[s] = time.perf_counter() - t0
            time.sleep(0.05)
        log, failed = [], []
        for s, out, p in procs:
            out.seek(0)
            log.append(f"== {s.name} (rc {p.returncode}, {seconds[s]:.1f} s)\n{out.read()}")
            out.close()
            if p.returncode != 0:
                failed.append(s.name)
        if not failed:
            tmp_lib = Path(tmp) / lib.name
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
                 str(tmp_lib)], capture_output=True, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        (build_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                               + "\n".join(log))
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def call(name: str, *args) -> None:
    """Run one C entry point; raise on a CUDA error."""
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed with cudaError {rc}")


def stream() -> int:
    """The current CUDA stream, where every kernel launches."""
    return torch.cuda.current_stream().cuda_stream


def ptr(t) -> int:
    """Device pointer of a tensor, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def kernel_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a kernel takes an activation like t in: bf16 for a bf16 t
    (serving's bf16 kernels), else fp32 (check_arg refuses any other)."""
    return torch.bfloat16 if t.dtype == torch.bfloat16 else torch.float32


def check_arg(name: str, t, shape, device, dtype=torch.float32) -> None:
    """Raise unless t is None or a contiguous tensor of this dtype (float32
    unless the kernel takes another) and shape on this device: what the
    kernels take. Nothing is cast."""
    if t is None:
        return
    if (t.dtype != dtype or t.device != device
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{name}: need contiguous {str(dtype).replace('torch.', '')} "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")
