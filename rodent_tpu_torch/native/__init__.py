"""ctypes bindings to the port's native host library (copy of
rodent_tpu/native/__init__.py).

The C++ sources beside this file (bvh_builder.cpp, obj_loader.cpp,
lz4.cpp, ref_bvh.cpp) are copies of the JAX package's: the SAH/SBVH BVH
builder, the OBJ loader, the LZ4 block codec and RefTracer's independent
single-ray BVH2 engine (tools/bench_ref). They are compiled with g++ at first
use into a shared library under build/rodent_torch_host/ at the repository
root; the file name carries a hash of the sources, the flags and the host
CPU, so an edited source builds anew, an unchanged one loads the built
library, and a library built with -march=native for one CPU is never
loaded on another (where it could stop on an illegal instruction).

There is no fallback: without g++, or when the build fails, asking for the
library raises; available() says beforehand whether it can be had. (The
JAX package quietly falls back to its numpy builder, which gives another
tree and other times.)
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "rodent_torch_host"
SOURCES = ("lz4.cpp", "bvh_builder.cpp", "obj_loader.cpp", "ref_bvh.cpp")
# the flags of rodent_tpu/native/Makefile, so both builds give the same tree
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")

_lib = None


def cpu_identity():
    """What -march=native compiles for: the vendor, model and feature flags
    of the first processor in /proc/cpuinfo, or the platform's machine and
    processor names where there is no such file."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    keep = ("vendor_id", "cpu family", "model", "model name", "flags",
            "Features", "CPU implementer", "CPU part")
    lines = []
    for line in text.splitlines():
        if not line.strip():
            break                      # the first processor only
        key = line.split(":", 1)[0].strip()
        if key in keep:
            lines.append(line.strip())
    return "\n".join(lines)


def library_path(build_dir=None):
    """Where the library for these exact sources, flags and host CPU
    lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(cpu_identity().encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    name = f"librodent_torch_host_{h.hexdigest()[:16]}.so"
    return Path(build_dir or BUILD_DIR) / name


def build(build_dir=None):
    """Compiles the sources with g++ unless the library for them exists.
    Returns its path. Raises RuntimeError without g++ or when it fails.
    Concurrent callers (test workers) wait on one lock file, so the
    library is built once."""
    out = library_path(build_dir)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("rodent_tpu_torch.native: g++ not found; the "
                           "host library cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
               *(str(_DIR / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("g++ failed on the host library:\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.rt_lz4_compress_bound.restype = ctypes.c_int
    lib.rt_lz4_compress_bound.argtypes = [ctypes.c_int]
    lib.rt_lz4_compress.restype = ctypes.c_int
    lib.rt_lz4_compress.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int]
    lib.rt_lz4_decompress.restype = ctypes.c_int
    lib.rt_lz4_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int]
    lib.rt_bvh_build2.restype = ctypes.c_void_p
    lib.rt_bvh_build2.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float]
    lib.rt_bvh_num_nodes.restype = ctypes.c_int64
    lib.rt_bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.rt_bvh_num_packets.restype = ctypes.c_int64
    lib.rt_bvh_num_packets.argtypes = [ctypes.c_void_p]
    lib.rt_bvh_copy.restype = None
    lib.rt_bvh_copy.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)] * 1 + [
        ctypes.POINTER(ctypes.c_int32)] + [
        ctypes.POINTER(ctypes.c_float)] * 4 + [
        ctypes.POINTER(ctypes.c_int32)] * 2
    lib.rt_bvh_free.restype = None
    lib.rt_bvh_free.argtypes = [ctypes.c_void_p]
    lib.rt_obj_load.restype = ctypes.c_void_p
    lib.rt_obj_load.argtypes = [ctypes.c_char_p]
    lib.rt_obj_counts.restype = None
    lib.rt_obj_counts.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.rt_obj_copy.restype = None
    lib.rt_obj_copy.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)] * 4 + [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p]
    lib.rt_obj_free.restype = None
    lib.rt_obj_free.argtypes = [ctypes.c_void_p]
    lib.rt_ref_build.restype = ctypes.c_void_p
    lib.rt_ref_build.argtypes = [ctypes.POINTER(ctypes.c_float),
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.c_int64]
    lib.rt_ref_num_nodes.restype = ctypes.c_int64
    lib.rt_ref_num_nodes.argtypes = [ctypes.c_void_p]
    lib.rt_ref_traverse.restype = ctypes.c_double
    lib.rt_ref_traverse.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.rt_ref_free.restype = None
    lib.rt_ref_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available():
    """True when the library is built or can be built here (g++ present
    and the build succeeds)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def lz4_compress(data: bytes) -> bytes:
    lib = _load()
    cap = lib.rt_lz4_compress_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.rt_lz4_compress(data, len(data), out, cap)
    if n < 0:
        raise ValueError("lz4 compression failed")
    return out.raw[:n]


def lz4_decompress(data: bytes, uncompressed_size: int) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(uncompressed_size)
    n = lib.rt_lz4_decompress(data, len(data), out, uncompressed_size)
    if n < 0:
        raise ValueError("lz4 decompression failed (malformed input)")
    if n != uncompressed_size:
        raise ValueError(f"lz4 size mismatch: {n} != {uncompressed_size}")
    return out.raw


def bvh_build(vertices, indices4, arity=8, packet=4, leaf_threshold=4,
              quality=1, leaf_cost=0.0):
    """Native BVH build: quality=1 -> SBVH (sweep SAH + spatial splits +
    unsplitting, the reference SplitBvhBuilder tier); quality=0 -> fast
    binned SAH. leaf_cost > 0 overrides the DP collapse's C_LEAF (the
    relative cost of a leaf-packet pop vs a node pop). Returns the arrays
    of accel.layout.WideBvh: (bounds, child, tri_v0, tri_e1, tri_e2,
    tri_n, prim_id, geom_id)."""
    lib = _load()
    verts = np.ascontiguousarray(vertices, np.float32)
    idx4 = np.ascontiguousarray(indices4, np.int32).reshape(-1, 4)
    num_tris = len(idx4)
    h = lib.rt_bvh_build2(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx4.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_tris, arity, packet, leaf_threshold, quality,
        float(leaf_cost))
    try:
        nn = lib.rt_bvh_num_nodes(h)
        npk = lib.rt_bvh_num_packets(h)
        bounds = np.empty((nn, 6, arity), np.float32)
        child = np.empty((nn, arity), np.int32)
        tv0 = np.empty((npk, packet, 3), np.float32)
        te1 = np.empty_like(tv0)
        te2 = np.empty_like(tv0)
        tn = np.empty_like(tv0)
        pid = np.empty((npk, packet), np.int32)
        gid = np.empty_like(pid)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rt_bvh_copy(h, bounds.ctypes.data_as(f32p),
                        child.ctypes.data_as(i32p),
                        tv0.ctypes.data_as(f32p), te1.ctypes.data_as(f32p),
                        te2.ctypes.data_as(f32p), tn.ctypes.data_as(f32p),
                        pid.ctypes.data_as(i32p), gid.ctypes.data_as(i32p))
    finally:
        lib.rt_bvh_free(h)
    return bounds, child, tv0, te1, te2, tn, pid, gid


class RefTracer:
    """The independent single-ray BVH2 engine of ref_bvh.cpp, with its own
    binned-SAH builder and scalar stack traversal: the bench_embree /
    bench_aila analog (tools/bench_embree/bench_embree.cpp), a second
    implementation that shares no code with the port's traversal or
    bvh_builder.cpp, to cross-check hits and to anchor throughput with a
    measurement the code under test did not produce. Host CPU, one
    thread, numpy in and out."""

    def __init__(self, vertices, indices4):
        lib = _load()
        self._lib = lib
        verts = np.ascontiguousarray(vertices, np.float32)
        idx4 = np.ascontiguousarray(indices4, np.int32).reshape(-1, 4)
        self._h = lib.rt_ref_build(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx4.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(idx4))
        self.num_nodes = int(lib.rt_ref_num_nodes(self._h))

    def traverse(self, org, dirs, tmin, tmax, any_hit=False):
        """Closest-hit (or first-hit) traversal of N rays. Returns (t (N,)
        f32, tmax kept on a miss; prim_id (N,) i32, -1 on a miss; seconds,
        timed inside the C engine)."""
        org = np.ascontiguousarray(org, np.float32).reshape(-1, 3)
        dirs = np.ascontiguousarray(dirs, np.float32).reshape(-1, 3)
        n = len(org)
        tmin = np.ascontiguousarray(
            np.broadcast_to(np.float32(tmin), (n,)), np.float32)
        tmax = np.ascontiguousarray(
            np.broadcast_to(np.float32(tmax), (n,)), np.float32)
        t_out = np.empty(n, np.float32)
        prim_out = np.empty(n, np.int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        secs = self._lib.rt_ref_traverse(
            self._h, org.ctypes.data_as(f32p), dirs.ctypes.data_as(f32p),
            tmin.ctypes.data_as(f32p), tmax.ctypes.data_as(f32p), n,
            1 if any_hit else 0, t_out.ctypes.data_as(f32p),
            prim_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return t_out, prim_out, float(secs)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_ref_free(self._h)
            self._h = None


def obj_load(path):
    """Native OBJ load (obj.cpp role): returns (vertices (V,3) f32,
    normals (V,3), texcoords (V,2), face_normals (T,3), indices (T*4,)
    i32, material names list, mtl lib list), or None when the file cannot
    be read."""
    lib = _load()
    h = lib.rt_obj_load(os.fsencode(path))
    if not h:
        return None
    try:
        cnt = (ctypes.c_longlong * 5)()
        lib.rt_obj_counts(h, cnt)
        nv, nt, nmat, nlibs, sbytes = [int(x) for x in cnt]
        verts = np.empty((nv, 3), np.float32)
        norms = np.empty((nv, 3), np.float32)
        texs = np.empty((nv, 2), np.float32)
        fnorm = np.empty((nt, 3), np.float32)
        idx = np.empty((nt * 4,), np.int32)
        sbuf = ctypes.create_string_buffer(max(sbytes, 1))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rt_obj_copy(h, verts.ctypes.data_as(f32p),
                        norms.ctypes.data_as(f32p),
                        texs.ctypes.data_as(f32p),
                        fnorm.ctypes.data_as(f32p),
                        idx.ctypes.data_as(i32p), sbuf)
    finally:
        lib.rt_obj_free(h)
    parts = sbuf.raw[:sbytes].split(b"\0")
    names = [p.decode("utf-8", "replace") for p in parts[:nmat]]
    libs = [p.decode("utf-8", "replace")
            for p in parts[nmat:nmat + nlibs]]
    return verts, norms, texs, fnorm, idx, names, libs
