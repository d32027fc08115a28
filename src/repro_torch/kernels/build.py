"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source ``repro_torch/csrc/<name>.cu`` is compiled at first use for
``sm_90a`` into its own library under ``build/repro_torch_kernels/`` at the
repository root (a directory ``.gitignore`` lists), keyed on a hash of the
source, the headers of ``csrc/`` and the flags, so a changed source or
header never loads a stale library.  The libraries have a plain C
interface: no PyTorch headers, so ``nvcc`` takes seconds.  :func:`compile_libraries` starts one ``nvcc`` per source, all at
once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes signatures of each library's C entry points (pointers and the
# stream as c_void_p, ints as c_int, floats as c_float; the return value is
# a cudaError_t)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "butterfly": {
        "butterfly_reduce_quant": [_P] * 6 + [_I] * 6 + [_P],
        "butterfly_reduce_quant_bincount": [_P] * 7 + [_I] * 5 + [_P],
        "butterfly_reduce_scratch": [_I] * 4 + [_P],
        "butterfly_dequant_restore": [_P] * 4 + [_I] * 5 + [_P],
        "butterfly_dequant_restore_norm": [_P] * 6 + [_I, _I, _I, _F, _I, _P],
        "butterfly_reduce_width": [_I],
        "butterfly_restore_norm_wave": [_I, _I, _P],
        "butterfly_restore_plan": [_I] * 4 + [_P],
    },
    "flash_attention": {
        "flash_attention": [_P, _P, _P, _P] + [_I] * 9 + [_P],
        "flash_attention_encode_ns": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    },
    "rmsnorm": {
        "rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _P],
    },
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def compile_library(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source and
    these flags exists.  Returns (library path, compiler log, seconds)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name and rename, so no process ever loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, log_path.read_text(), time.perf_counter() - t0


def compile_libraries(names=tuple(SIGNATURES)) -> dict:
    """:func:`compile_library` for each name, one ``nvcc`` per source, all
    started together.  Returns {name: (library path, compiler log, seconds)}."""
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(compile_library, names)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The compiled kernel library ``name``, built at first use."""
    path, _, _ = compile_library(name)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
