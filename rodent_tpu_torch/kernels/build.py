"""nvcc build and ctypes loader for the CUDA sources in csrc/.

The sources are compiled at first use with nvcc into a plain-C-ABI shared
library under build/rodent_torch_kernels/ at the repository root; the file
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads the built library. Only sources in the
repository are used. Without nvcc (and without a built library) asking
for the library raises: there is no fallback.

-fmad=false keeps every float operation separately rounded, as the plain
torch versions compute them, so a kernel and its plain version agree bit
for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rodent_torch_kernels"
SOURCES = ("bvh_traverse.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
# nodes, tris, rays, n, arity, packet, any_hit, stack_cap, t, u, v, prim,
# geom: the arguments every traversal entry starts with
_TRAVERSE = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
# name -> (restype, argtypes) of every C entry the library exports
_ENTRIES = {
    "rt_bvh_traverse": (ctypes.c_int, _TRAVERSE + [_P]),
    "rt_bvh_traverse_prefetch": (ctypes.c_int, _TRAVERSE + [_P]),
    "rt_bvh_traverse_count": (ctypes.c_int, _TRAVERSE + [_P, _P, _P]),
}

_libs = {}  # library path -> loaded CDLL


def find_nvcc():
    """nvcc on PATH, else under $CUDA_HOME or the default CUDA prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def library_path(build_dir=None):
    """Where the library for these exact sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    name = f"librodent_torch_{h.hexdigest()[:16]}.so"
    return Path(build_dir or BUILD_DIR) / name


def build(build_dir=None):
    """Compiles csrc/ with nvcc unless the library for these exact sources
    exists. Returns (path, nvcc's output) — the output, which carries
    ptxas' per-kernel register and spill lines, is None when nothing was
    built. Raises RuntimeError without nvcc or when nvcc fails."""
    out = library_path(build_dir)
    if out.exists():
        return out, None
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("rodent_tpu_torch: nvcc not found; the CUDA "
                           "kernels cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def load_library(build_dir=None):
    """The kernel library, built on first use and loaded with ctypes."""
    path, _ = build(build_dir)
    lib = _libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        for name, (res, args) in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _libs[path] = lib
    return lib
