"""Sharded rendering and traversal over torch.distributed (torch port of
rodent_tpu/parallel/mesh.py).

The renderer's two parallel axes are the JAX package's:

- "px" (data parallel over pixels): each px rank owns a contiguous strip
  of the image (the film padded to n_px equal strips), the scene is
  replicated, no communication is needed while tracing, and the strips are
  all-gathered into the whole image at the end;
- "sp" (sample parallel): the sp ranks of one strip trace disjoint sample
  ranges and their partial films are summed by an all-reduce.

JAX runs both axes as one SPMD program over a Mesh of devices in one
process. Here every device is driven by a process of its own, a rank of a
torch.distributed group, laid out as JAX lays out its devices,
reshape(n_sp, n_px): sp = rank // n_px, px = rank % n_px. The caller starts
the default group (torchrun, init_group, or run_group below); make_mesh
cuts it into the sp and px subgroups.

Backends: NCCL for CUDA tensors, one card per rank; gloo on the CPU and
where several ranks share one card (NCCL refuses two ranks on one GPU).
A rank's card becomes its process's current CUDA device (init_group,
make_mesh), and the kernel wrappers launch on their tensors' own card
whatever the current device is. The collectives take the tensors on their
device with either backend: gloo takes CUDA tensors in all_reduce and
all_gather and moves them through host memory itself (the sharded films
of chip_smoke.py phase 17 go through it), while the tracing and shading
stay on the rank's device. A collective
over a group of one rank is skipped, as JAX drops a psum over an axis of
size 1.

The defaults follow the port's renderers: packet=True (K1 on the card, its
plain version on the CPU) and engine="packet" for traverse_sharded, where
the JAX package defaults to its dual-queue engine (packet=False,
engine="tiled").
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..render.integrator import render_iteration_persistent, render_sample
from ..traversal.packet import traverse_packet
from ..traversal.tiled import traverse_tiled
from ..utils.profiling import synchronize


@dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_sp, n_px) mesh: its coordinates, its
    device, and the subgroups it belongs to (sp_group: the ranks of its
    strip, px_group: the ranks of its sample range)."""
    n_sp: int
    n_px: int
    sp: int
    px: int
    device: torch.device
    sp_group: object
    px_group: object

    @property
    def rank(self):
        return self.sp * self.n_px + self.px


def free_port():
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device():
    """The card of this rank: cuda:{LOCAL_RANK % device_count()}, so that
    ranks beyond the card count share cards. Raises without a card: the CPU
    is taken only when asked for."""
    if not torch.cuda.is_available():
        raise RuntimeError("rodent_tpu_torch.parallel: no CUDA device is "
                           "available; pass device='cpu' for the CPU")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device(f"cuda:{local % torch.cuda.device_count()}")


def _bind():
    """init_process_group's arguments that bind an NCCL rank to its card,
    which also becomes the process's current CUDA device."""
    device = rank_device()
    torch.cuda.set_device(device)
    return {"device_id": device}


def init_group(cpu=False):
    """Joins the default process group: from torchrun's variables (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) where they are set, else a group
    of one rank. NCCL on the card, gloo with cpu=True. Returns True when
    this call started the group (its caller then ends it with
    dist.destroy_process_group()), False when it was already up."""
    if dist.is_initialized():
        return False
    backend, bound = ("gloo", {}) if cpu else ("nccl", _bind())
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **bound)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1, **bound)
    return True


def make_mesh(n_px=None, n_sp=1, device=None):
    """The ("sp", "px") mesh over the default process group, which the
    caller has started (mesh.py:32). n_px defaults to world // n_sp (pure
    image-plane parallelism); n_px * n_sp must be the group's size. device
    defaults to rank_device(); a card becomes this process's current CUDA
    device. Every rank makes the same subgroups in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: start the default process group "
                           "first (torchrun, init_group or run_group)")
    world = dist.get_world_size()
    if n_px is None:
        n_px = world // n_sp
    if n_px < 1 or n_px * n_sp != world:
        raise ValueError(f"make_mesh: n_px {n_px} x n_sp {n_sp} must be "
                         f"the group's {world} ranks")
    device = torch.device(device) if device is not None else rank_device()
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    sp_groups = [dist.new_group([sp * n_px + px for sp in range(n_sp)])
                 for px in range(n_px)]
    px_groups = [dist.new_group([sp * n_px + px for px in range(n_px)])
                 for sp in range(n_sp)]
    sp, px = divmod(dist.get_rank(), n_px)
    return Mesh(n_sp, n_px, sp, px, device, sp_groups[px], px_groups[sp])


def to_device(tree, device):
    """A dict of tensors (a scene, a BVH) with every tensor on `device`;
    other values as they are."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def shard_scene(scene, mesh):
    """The scene's tensors on this rank's device (mesh.py:42): every rank
    holds its own copy, which is the replication."""
    return to_device(scene, mesh.device)


def all_reduce_sum(x, group):
    """The sum of x over the ranks of `group` (x itself is not changed)."""
    if dist.get_world_size(group) == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def all_gather_cat(x, group=None):
    """The ranks' x (equal shapes) concatenated along dim 0 in rank order;
    group None is the whole group."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _split(width, height, spp, mesh):
    total = width * height
    if spp % mesh.n_sp:
        raise ValueError(f"spp {spp} must divide over the {mesh.n_sp} sp "
                         "ranks")
    # uneven W*H: the film is padded to n_px strips of `local` rows; the
    # padded rows are sliced off after the gather
    return total, -(-total // mesh.n_px), spp // mesh.n_sp


def render_iteration_sharded(scene, camera, film, width, height, spp,
                             iteration, mesh, packet=True, sort=False):
    """One progressive iteration over the mesh (mesh.py:49-101). Each px
    rank traces its strip, pixel ids px*local + i clamped to the last pixel
    (the padded rows trace duplicates of it and are sliced off), sp rank sp
    its samples sp*spp_local + i; the partial films are summed over the sp
    ranks, weighted 1/spp, and the strips gathered. Every rank returns film
    + the iteration's radiance, the whole (W*H, 3) film, on its device."""
    total, local, spp_local = _split(width, height, spp, mesh)
    scene = shard_scene(scene, mesh)
    dev = mesh.device
    pixel_ids = torch.clamp(
        mesh.px * local + torch.arange(local, dtype=torch.int64, device=dev),
        max=total - 1)
    part = torch.zeros((local, 3), dtype=torch.float32, device=dev)
    for i in range(spp_local):
        part = render_sample(scene, camera, part, width, height,
                             mesh.sp * spp_local + i, iteration,
                             pixel_ids=pixel_ids, packet=packet, sort=sort)
    # 1/spp weighting: the film holds per-iteration means
    strip = all_reduce_sum(part, mesh.sp_group) * (1.0 / spp)
    return film.to(dev) + all_gather_cat(strip, mesh.px_group)[:total]


def render_iteration_persistent_sharded(scene, camera, film, width,
                                        height, spp, iteration, mesh,
                                        return_steps=False, **persistent):
    """The persistent-wavefront iteration over the mesh (mesh.py:104-146):
    each px rank runs the regeneration pool on its own strip
    (render_iteration_persistent with pixel_lo=px*local, n_pixels=local,
    sample_lo=sp*spp_local and spp_weight=1/spp, splatting into a strip
    film), the partials are summed over the sp ranks and the strips
    gathered. The film equals the single-device persistent film: RNG seeds
    depend only on (sample, iteration, pixel). persistent: the options of
    render_iteration_persistent (pool, packet, sort, retire_every,
    compact, ...; packet defaults to True, K1). Returns the whole film on
    every rank, and with return_steps=True (film, steps), steps the
    (n_sp, n_px) int64 array of every rank's wavefront steps."""
    total, local, spp_local = _split(width, height, spp, mesh)
    scene = shard_scene(scene, mesh)
    dev = mesh.device
    delta, steps = render_iteration_persistent(
        scene, camera, torch.zeros((local, 3), dtype=torch.float32,
                                   device=dev),
        width, height, spp_local, iteration, pixel_lo=mesh.px * local,
        n_pixels=local, sample_lo=mesh.sp * spp_local, spp_weight=1.0 / spp,
        return_steps=True, **persistent)
    delta = all_reduce_sum(delta, mesh.sp_group)
    out = film.to(dev) + all_gather_cat(delta, mesh.px_group)[:total]
    if not return_steps:
        return out
    st = all_gather_cat(torch.tensor([steps], dtype=torch.int64, device=dev))
    return out, st.cpu().numpy().reshape(mesh.n_sp, mesh.n_px)


def traverse_sharded(dev, rays, mesh=None, any_hit=False, engine="packet",
                     **engine_kwargs):
    """Scene-replicated, ray-sharded traversal (mesh.py:149-211): the
    make_rays dict's B rays are split over all ranks of the mesh in rank
    order, padded with dead rays (tmax -1) to equal shares, traced on each
    rank's device and the hits gathered: every rank returns all B hits.
    engine: "packet" (K1; the port's default), "packet-hbm" and
    "packet-giga" (K2, the prefetching kernel, which the big-scene
    tiers take), or "tiled" (the dual-queue engine,
    traversal/tiled.py, the JAX default). engine_kwargs are the engine's
    own options: traverse_packet's (tile_rows, ablate, ...; the TPU knobs
    multi, carry_top and the like are refused there) or traverse_tiled's
    (compact_stages, sub_batches)."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.n_sp * mesh.n_px
    b = rays["tmax"].shape[0]
    per = -(-b // n_dev)
    lo, hi = min(mesh.rank * per, b), min((mesh.rank + 1) * per, b)

    def share(k, x):
        x = x[lo:hi].to(mesh.device)
        if hi - lo == per:
            return x
        fill = torch.full((per - (hi - lo),) + x.shape[1:],
                          -1.0 if k == "tmax" else 0.0, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, fill])

    local = {k: share(k, v) for k, v in rays.items()}
    dev = to_device(dev, mesh.device)
    if engine == "tiled":
        hit = traverse_tiled(dev, local, any_hit=any_hit, **engine_kwargs)
    elif engine in ("packet", "packet-hbm", "packet-giga"):
        hit = traverse_packet(dev, local, any_hit=any_hit,
                              prefetch=engine != "packet", **engine_kwargs)
    else:
        raise ValueError(f"unknown traversal engine {engine!r}")
    return {k: all_gather_cat(v)[:b] for k, v in hit.items()}


def run_calls(calls, device=None):
    """A rank body for run_group: runs each (fn, shape, args, kwargs) of
    `calls` on every rank, as fn(*args, mesh=make_mesh(*shape, device),
    **kwargs) where shape is (n_px, n_sp), or as fn(*args, **kwargs) where
    it is None (a tool that joins the group itself). Before a mesh's call
    the tensors in its args (in dicts, lists and tuples) are put on the
    rank's device, each object once per rank, and each subgroup of the
    mesh runs its first collective (where NCCL sets up its communicator),
    so that the call's time holds no upload and no set-up. Returns, per
    call, {"out": its result, "seconds": its wall time from a barrier
    before it to a barrier after its result is ready}."""
    res, placed = [], {}
    for fn, shape, args, kwargs in calls:
        if shape is not None:
            mesh = make_mesh(*shape, device=device)
            args = _place(args, mesh.device, placed)
            kwargs = dict(kwargs, mesh=mesh)
            for group in (mesh.sp_group, mesh.px_group):
                all_reduce_sum(torch.zeros(1, device=mesh.device), group)
        dist.barrier()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        dist.barrier()
        res.append({"out": out, "seconds": time.perf_counter() - t0})
    return res


def _place(x, device, placed):
    """x with every tensor in it on `device`; `placed` maps the id of an
    object already placed to its copy, so that a scene shared by several
    calls is uploaded once."""
    key = (id(x), str(device))
    if key in placed:
        return placed[key][1]
    if isinstance(x, torch.Tensor):
        y = x.to(device)
    elif isinstance(x, dict):
        y = {k: _place(v, device, placed) for k, v in x.items()}
    elif isinstance(x, (list, tuple)):
        y = type(x)(_place(v, device, placed) for v in x)
    else:
        return x
    placed[key] = (x, y)     # x held, so that its id is not reused
    return y


def _sync(x):
    """Waits for the device work behind every tensor in a result."""
    if isinstance(x, torch.Tensor):
        synchronize(x)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _sync(v)


def _host(x):
    """A result made picklable without shared memory: tensors as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _rank_main(fn, rank, world, backend, port, results, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world,
                                **(_bind() if backend == "nccl" else {}))
        try:
            out = _host(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_group(fn, world, backend, *args, timeout=600.0):
    """Runs fn(*args) on `world` local processes that form a
    torch.distributed group over `backend` ("gloo" or "nccl"), started
    with the spawn method (fn must be importable: a module's function).
    Each child sees torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) and holds torch to one thread. Returns the
    ranks' results in rank order, tensors as numpy arrays. Raises when a
    rank fails or dies, or when the group has not finished within
    `timeout` seconds; the other ranks are then terminated."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, port, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"run_group: rank(s) {dead} died "
                                       "without a result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_group: no result within "
                                       f"{timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"run_group: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
    return [got[r] for r in range(world)]

