"""The 1-D mesh the sharded stages run over — port of
``shot_fpfh_tpu.parallel.mesh``.

JAX drives every device of its mesh from one controller; PyTorch runs one
process a device.  A mesh here is one rank's view of a ``torch.distributed``
process group: its rank, the world size, the rank's ``torch.device`` and the
backend.  Every rank is given the same full host arrays, which is JAX's
multi-process contract (JAX ``mesh.py:48-55``): :func:`replicate` places an
array on the rank's device, :func:`shard_rows` takes the rank's block of
the padded rows, and :func:`host_array` all-gathers the equal-sized blocks,
so every rank returns the same full array.

The backend is NCCL when every rank has a card of its own, and gloo
otherwise: on CPU ranks, and on ranks that share a card (NCCL refuses two
ranks on one device); the ranks post their host and device to the
rendezvous store and read each other's before they choose.  Gloo moves CPU tensors only, so under gloo the
collective helpers copy a CUDA tensor through the host; the computation
stays on the rank's device.

Every rank must make the same collectives in the same order, so every
branch of a sharded stage is decided from replicated data; :func:`agree`
checks such inputs across the ranks and raises on every rank when they
differ, instead of leaving the next collective to hang.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve

logger = logging.getLogger(__name__)

POINTS_AXIS = "points"


class Mesh:
    """One rank's view of a 1-D mesh of ``size`` ranks.  ``backend`` is
    None for a mesh of one rank with no process group (its collectives are
    the identity)."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: str | None,
                 axis: str = POINTS_AXIS):
        self.rank, self.size, self.device, self.backend = rank, size, device, backend
        self.axis = axis

    @property
    def devices(self) -> np.ndarray:
        """One entry a rank, as JAX's ``mesh.devices`` (its ``.size`` is the
        rank count)."""
        return np.arange(self.size)

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, "
                f"backend={self.backend}, axis={self.axis!r})")


def _rank_device(device, rank: int) -> torch.device:
    """The rank's device: ``device`` when it names an index or the CPU,
    else ``cuda:{LOCAL_RANK % device_count}``."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _init_group(device, init_method: str, rank: int, world_size: int, timeout) -> None:
    """Initialise the default group over ``init_method``'s store.  Before
    that, every rank posts its host and device to the store and reads the
    others': the backend is NCCL when every rank has a card of its own, and
    gloo otherwise, so every rank picks the same one."""
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    store, me, world = next(dist.rendezvous(init_method, rank, world_size, **kwargs))
    dev = _rank_device(device, me)
    store.set(f"mesh/device/{me}", f"{socket.gethostname()}/{dev}")
    seen = [store.get(f"mesh/device/{r}").decode() for r in range(world)]
    nccl = own_cards(seen) and dist.is_nccl_available()
    dist.init_process_group("nccl" if nccl else "gloo", store=store, rank=me,
                            world_size=world, **kwargs)
    atexit.register(shutdown_distributed)


def shutdown_distributed() -> None:
    """End the default process group, if one is up
    (``destroy_process_group``, local to this rank).  Every group this
    module starts registers it to run at exit, as
    ``jax.distributed.initialize`` registers its shutdown: a gloo group
    left to the interpreter's own teardown now and then aborted the process
    after its work was done (``terminate called without an active
    exception``, no Python frame left), whatever its store."""
    if dist.is_initialized():
        dist.destroy_process_group()


def own_cards(rank_devices: list[str]) -> bool:
    """Whether every rank has a card of its own, from each rank's
    ``"host/device"``: all CUDA devices, no two the same."""
    return (all("/cuda" in d for d in rank_devices)
            and len(set(rank_devices)) == len(rank_devices))


def launch_size() -> int:
    """Ranks of this launch: the default group's size once initialised, else
    the launcher's ``WORLD_SIZE`` (1 without a launcher)."""
    return dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", 1))


def make_mesh(n_devices: int = 0, axis: str = POINTS_AXIS, *, device=None,
              init_method: str | None = None, rank: int | None = None,
              world_size: int | None = None, timeout: float | None = None) -> Mesh:
    """1-D mesh over up to ``n_devices`` ranks (0 = the whole world).

    Uses the default process group when it is initialised; otherwise
    initialises it from ``init_method`` (with ``rank`` and ``world_size``),
    or from a launcher's environment (``torchrun``: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).  Without either, the
    world is this one process and the mesh has one rank and no group.
    ``n_devices`` above the world size gives the world, as JAX's
    ``devices[:n]`` truncates; ``n_devices`` below the world size raises,
    since a rank outside the mesh would have nothing to run.  ``timeout``: seconds
    a collective may wait (a hang then fails).  A group started here is
    ended at exit (:func:`shutdown_distributed`)."""
    if axis != POINTS_AXIS:
        raise ValueError(
            f"mesh axis must be {POINTS_AXIS!r} (the name every sharded stage "
            f"binds); got {axis!r}")
    if not dist.is_initialized():
        if init_method is None and "WORLD_SIZE" not in os.environ:
            return Mesh(0, 1, _rank_device(device, 0), None, axis)
        if init_method is None:     # the launcher's RANK, WORLD_SIZE, MASTER_ADDR/PORT
            _init_group(device, "env://", -1, -1, timeout)
        else:
            _init_group(device, init_method, rank, world_size, timeout)
    world, me = dist.get_world_size(), dist.get_rank()
    dev = _rank_device(device, me)
    backend = dist.get_backend()
    if 0 < n_devices < world:
        raise ValueError(
            f"a mesh of {n_devices} ranks in a launch of {world}: every rank of the "
            f"launch runs the sharded stages, so launch {n_devices} ranks (torchrun "
            f"--nproc_per_node {n_devices}) or pass n_devices=0")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    logger.info("mesh: rank %d of %d on %s, backend %s%s", me, world, dev, backend,
                " (collectives copy through the host)"
                if backend == "gloo" and dev.type == "cuda" else "")
    return Mesh(me, world, dev, backend, axis)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` (array or tensor) with zeros along ``axis`` to a multiple
    of ``multiple``; returns ``(padded, original length)``."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = target - n
        return torch.cat([x, x.new_zeros(shape)], dim=axis), n
    widths = [(0, 0)] * np.ndim(x)
    widths[axis] = (0, target - n)
    return np.pad(np.asarray(x), widths), n


def replicate(x, mesh: Mesh) -> torch.Tensor:
    """``x`` on the rank's device (every rank holds all of it)."""
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    arr = np.asarray(x)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.as_tensor(arr, device=mesh.device)


def row_block(n: int, mesh: Mesh) -> tuple[int, int]:
    """``(start, stop)`` of the rank's block of ``n`` rows padded to a
    multiple of the mesh size."""
    per = -(-n // mesh.size)
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_rows(x, mesh: Mesh, axis: str = POINTS_AXIS) -> torch.Tensor:
    """The rank's block of the rows of ``x`` padded with zeros to a multiple
    of the mesh size, on the rank's device.  ``axis`` must name the mesh's
    one axis (JAX's ``NamedSharding`` raises for an unknown axis name)."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no axis {axis!r}; its axis is {mesh.axis!r}")
    return local_rows(replicate(x, mesh), mesh)


def local_rows(x: torch.Tensor, mesh: Mesh | None, fill: float = 0.0) -> torch.Tensor:
    """The rows of ``x`` this process computes: all of them without a mesh,
    else the rank's block of them padded with ``fill`` to a multiple of the
    mesh size (a stage written over :func:`local_rows` and
    :func:`gather_rows` runs the same code on one device and sharded)."""
    if mesh is None:
        return x
    start, stop = row_block(x.shape[0], mesh)
    n_pad = (stop - start) * mesh.size - x.shape[0]
    if n_pad:
        x = torch.cat([x, x.new_full((n_pad, *x.shape[1:]), fill)])
    return x[start:stop]


def gather_rows(block: torch.Tensor, n: int, mesh: Mesh | None) -> torch.Tensor:
    """The first ``n`` rows of every rank's :func:`local_rows` block
    gathered (``block`` itself without a mesh)."""
    return block if mesh is None else all_gather_rows(block, mesh)[:n]


def all_reduce_sums(tensors, mesh: Mesh | None) -> tuple:
    """Each float tensor of ``tensors`` summed over the ranks, in one
    ``all_reduce`` (the tensors themselves without a mesh)."""
    if mesh is None:
        return tuple(tensors)
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return tuple(out)


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor a collective moves: on the host under gloo, bool as
    uint8, contiguous."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.contiguous()


def all_gather_rows(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal-sized block, concatenated in rank order, on the
    rank's device (the same full tensor on every rank)."""
    if mesh.backend is None:
        return block
    wire = _wire(block, mesh)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire)
    return torch.cat(parts).to(device=block.device, dtype=block.dtype)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (the same on every rank)."""
    if mesh.backend is None:
        return t
    wire = _wire(t, mesh).clone()
    dist.all_reduce(wire)
    return wire.to(device=t.device, dtype=t.dtype)


def ring_pass(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Send ``t`` to rank ``(rank + 1) % n`` and return what rank
    ``(rank − 1) % n`` sent (ppermute by one round the ring)."""
    if mesh.size == 1:
        return t
    wire = _wire(t, mesh)
    out = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, (mesh.rank + 1) % mesh.size),
           dist.P2POp(dist.irecv, out, (mesh.rank - 1) % mesh.size)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(device=t.device, dtype=t.dtype)


def agree(label: str, mesh: Mesh, *values) -> None:
    """Raise on every rank unless every rank passed the same ``values``
    (whole numbers: the inputs of a branch every rank must take alike)."""
    if mesh.backend is None:
        return
    mine = torch.tensor([[int(v) for v in values]], dtype=torch.int64, device=mesh.device)
    rows = host_array(mine, mesh)
    if not (rows == rows[0]).all():
        raise RuntimeError(f"ranks disagree on {label}: {rows.tolist()} (every rank must "
                           "be given the same full inputs)")


def host_array(block: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The ranks' equal-sized blocks gathered to one host array, the same
    on every rank (callers drop the pad rows)."""
    return all_gather_rows(block, mesh).cpu().numpy()
