"""nvcc build and ctypes loader for the CUDA sources in csrc/.

The sources are compiled at first use with nvcc into plain-C-ABI shared
libraries under build/rodent_torch_kernels/ at the repository root; a file
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads the built library. Only sources in the
repository are used. Without nvcc (and without a built library) asking
for a library raises: there is no fallback.

Six libraries: "main" (bvh_traverse.cu) holds K1, K2 and K3, the kernels
of the render and benchmark paths; "options" (the same source with
-DRT_OPTIONS) holds K4, the options of the legacy Pallas body; "group"
(the same source with -DRT_GROUP) holds K1-K3 in two bodies, the group
stack and the first body, for experiments/ab_body.py, which times them
against each other; "tile" (bvh_tile.cu) holds K5 and K6, the traversals
whose stack is shared by a tile of rays, in the warp schedule, which the
wrappers launch; "tile_v1" (the same source with -DRT_TILE_V1) holds K5
and K6 in their first schedule, for experiments/ab_tile_body.py, which
times the two schedules against each other; "probes" (probes.cu) holds the
micro-probes of rodent_tpu_torch.experiments.probe_* and vpu_dtype_bench.
Each is built at its first use, so that none delays K1's first launch;
build_all() starts the six nvcc runs at once. A library's hash covers
its source and the header it includes (bvh_common.cuh).

-fmad=false keeps every float operation separately rounded, as the plain
torch versions compute them, so a kernel and its plain version agree bit
for bit.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rodent_torch_kernels"
HEADERS = ("bvh_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# library -> (its source in csrc/, its extra nvcc flags)
LIBRARIES = {"main": ("bvh_traverse.cu", ()),
             "options": ("bvh_traverse.cu", ("-DRT_OPTIONS",)),
             "group": ("bvh_traverse.cu", ("-DRT_GROUP",)),
             "tile": ("bvh_tile.cu", ()),
             "tile_v1": ("bvh_tile.cu", ("-DRT_TILE_V1",)),
             "probes": ("probes.cu", ())}

_P = ctypes.c_void_p
_I = ctypes.c_int
# nodes, tris, rays, n, arity, packet, any_hit, stack_cap, t, u, v, prim,
# geom: the arguments every traversal entry starts with
_TRAVERSE = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
# library -> {name: (restype, argtypes)} of every C entry it exports
_ENTRIES = {
    "main": {
        "rt_bvh_traverse": (ctypes.c_int, _TRAVERSE + [_P]),
        "rt_bvh_traverse_prefetch": (ctypes.c_int, _TRAVERSE + [_P]),
        "rt_bvh_traverse_count": (ctypes.c_int, _TRAVERSE + [_P, _P, _P]),
    },
    "group": {
        # ..., pops, leaf_pops, variant, body, stream
        "rt_group_traverse": (ctypes.c_int, _TRAVERSE + [_P, _P, _I, _I,
                                                         _P]),
        # body, variant, arity, packet, any_hit, stack_cap, blocks_per_sm
        # (out)
        "rt_group_traverse_occupancy": (ctypes.c_int, [_I, _I, _I, _I, _I,
                                                       _I, _P]),
    },
    "options": {
        "rt_bvh_traverse_option": (ctypes.c_int, _TRAVERSE + [
            _P, _P, ctypes.c_int, _P]),
    },
    "tile": {
        # nodes, tris, rays, n, packet, any_hit, tile_rows, mode,
        # stack_cap, t, u, v, prim, geom, pops, leaf_pops, stream
        "rt_bvh_traverse_tile": (ctypes.c_int, [
            _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P,
            _P, _P, _P]),
        # nodes, tris, rays, n, tile_rays, any_hit, stack_cap, ablate,
        # max_iters, t, u, v, prim, geom, pops, leaf_pops, stream
        "rt_bvh_traverse_pair": (ctypes.c_int, [
            _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P,
            _P, _P, _P, _P]),
        # kernel (0 K5, 1 K6), packet, any_hit, mode, tile, stack_cap,
        # out (6 ints: registers, static and dynamic shared bytes, local
        # bytes, resident blocks per SM, threads)
        "rt_bvh_tile_resources": (ctypes.c_int, [_I, _I, _I, _I, _I, _I,
                                                 _P]),
    },
    "probes": {
        # probe, body, arg, arg2, blocks_per_sm (out)
        "rt_probe_occupancy": (ctypes.c_int, [_I, _I, _I, _I, _P]),
        # body, x, out, stream
        "rt_probe_mosaic": (ctypes.c_int, [_I, _P, _P, _P]),
        "rt_probe_mosaic2": (ctypes.c_int, [_I, _P, _P, _P]),
        # body, tbl, idx, out, rows, axis, pages, smem, copies, stream
        "rt_probe_gather": (ctypes.c_int, [_I, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _P]),
        # mode, tab, out, copies, stream
        "rt_probe_mosaic3": (ctypes.c_int, [_I, _P, _P, _I, _P]),
        # mode, streams, tab, out, copies, stream
        "rt_probe_chain": (ctypes.c_int, [_I, _I, _P, _P, _I, _P]),
        # feats, tab, out, aux, zero, copies, stream
        "rt_probe_body": (ctypes.c_int, [_I, _P, _P, _P, _I, _I, _P]),
        # body, tab, out, copies, stream
        "rt_probe_dyn_cost": (ctypes.c_int, [_I, _P, _P, _I, _P]),
        # dtype, x, out, words, copies, c1, c2, c3, stream
        "rt_probe_vpu": (ctypes.c_int, [_I, _P, _P, ctypes.c_longlong, _I,
                                        ctypes.c_uint, ctypes.c_uint,
                                        ctypes.c_uint, _P]),
    },
}

# the two schedules of bvh_tile.cu export the same entries
_ENTRIES["tile_v1"] = _ENTRIES["tile"]

_libs = {}  # library path -> loaded CDLL
_loaded = {}  # (build directory, kind) -> loaded CDLL


def find_nvcc():
    """nvcc on PATH, else under $CUDA_HOME or the default CUDA prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def _flags(kind):
    return NVCC_FLAGS + LIBRARIES[kind][1]


def library_path(build_dir=None, kind="main"):
    """Where the library `kind` for these exact sources and flags lives."""
    h = hashlib.sha256(" ".join(_flags(kind)).encode())
    for name in (LIBRARIES[kind][0], *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    stem = "librodent_torch" if kind == "main" else f"librodent_torch_{kind}"
    return Path(build_dir or BUILD_DIR) / f"{stem}_{h.hexdigest()[:16]}.so"


def build(build_dir=None, kind="main"):
    """Compiles csrc/ into the library `kind` with nvcc unless it exists
    for these exact sources. Returns (path, nvcc's output) — the output,
    which carries ptxas' per-kernel register and spill lines, is None when
    nothing was built. Raises RuntimeError without nvcc or when nvcc
    fails. Processes that ask for one library at once (the ranks of a
    sharded render) wait on a lock file per library, so it is built
    once."""
    out = library_path(build_dir, kind)
    if out.exists():
        return out, None
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("rodent_tpu_torch: nvcc not found; the CUDA "
                           "kernels cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f".{kind}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, None
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(kind), "-o", str(tmp),
               str(CSRC / LIBRARIES[kind][0])]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {kind} library:\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, out)
    return out, res.stdout + res.stderr


def build_all(build_dir=None):
    """Builds every library at once, one nvcc each. Returns {kind: (path,
    nvcc's output)}."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futures = {k: pool.submit(build, build_dir, k) for k in LIBRARIES}
        return {k: f.result() for k, f in futures.items()}


def load_library(build_dir=None, kind="main"):
    """The kernel library `kind`, built on first use and loaded with
    ctypes. Its sources are hashed at the first call for each build
    directory and kind only, since every launch asks for its library: a
    source edited after that call is built by the next process."""
    key = (str(build_dir or BUILD_DIR), kind)
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    path, _ = build(build_dir, kind)
    lib = _libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        for name, (res, args) in _ENTRIES[kind].items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _libs[path] = lib
    _loaded[key] = lib
    return lib
