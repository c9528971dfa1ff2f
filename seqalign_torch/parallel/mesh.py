"""The port's device mesh: an ordered list of devices, and the processes
around it.

The JAX package's mesh (``seqalign_tpu/parallel/mesh.py``) is a
``jax.sharding.Mesh`` with one ``data`` axis: a padded batch is cut into
one contiguous block a device (``batch_sharding``), the score matrix
lies on every device (``replicated``), and ``shard_map`` runs each block
where it lies.  PyTorch has no such object.  Here the mesh is an ordered
list of ``torch.device`` entries, and the callers (``parallel/batch.py``,
``parallel/sequence.py``) queue each entry's work themselves, on a CUDA
stream of its own, under ``DataMesh.on``.

Entries may repeat.  ``["cpu"] * 8`` is the stand-in for the JAX tests'
eight virtual CPU devices (``--xla_force_host_platform_device_count=8``),
not a new feature, and ``["cuda:0"] * 4`` puts four entries on one card:
their streams then share it, so such a mesh measures the pipeline's
overhead, not scaling across cards.

Across processes (``torch.distributed``) each process owns its local
list, all of one length, and the global mesh is every process's list in
rank order.  The collectives move host tensors only, a few bytes a pair,
so they go through gloo, which also works when several ranks share one
card (NCCL refuses that).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from .. import config

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


class DataMesh:
    """A 1-D data mesh: this process's entries (``devices``, one CUDA
    stream each on a CUDA device, None on the CPU), its ``rank`` among
    ``world_size`` processes, ``size`` entries in all, and ``first``, the
    global index of this process's first entry."""

    def __init__(self, devices, rank: int = 0, world_size: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.rank, self.world_size = rank, world_size
        self.streams = tuple(
            torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in self.devices)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local_size * self.world_size

    @property
    def first(self) -> int:
        return self.rank * self.local_size

    def rows(self, total: int, entry: int) -> slice:
        """The contiguous block of a padded batch of ``total`` rows that
        local entry ``entry`` holds (the JAX ``batch_sharding``):
        ``total`` must be a multiple of ``size``."""
        if total % self.size:
            raise ValueError(f"a batch of {total} does not split over "
                             f"{self.size} mesh entries")
        per = total // self.size
        lo = (self.first + entry) * per
        return slice(lo, lo + per)

    def local_rows(self, total: int) -> slice:
        """The rows of this process's entries, one block."""
        return slice(self.rows(total, 0).start,
                     self.rows(total, self.local_size - 1).stop)

    @contextlib.contextmanager
    def on(self, entry: int):
        """Queue work for local entry ``entry``: its device and, on a
        CUDA device, its stream current (the kernel wrappers launch on
        the current stream)."""
        stream = self.streams[entry]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[entry]), \
                torch.cuda.stream(stream):
            yield

    def hand_over(self, x: torch.Tensor, src: int, dst=None):
        """``x``, made by work queued for entry ``src``, for the work
        queued next for entry ``dst`` (None: the current stream of the
        first entry's device): on that device, ordered after ``src``'s
        work by an event, and its memory kept until that stream has used
        it."""
        src_stream = self.streams[src]
        device = self.devices[0 if dst is None else dst]
        if dst is None:
            dst_stream = (torch.cuda.current_stream(device)
                          if device.type == "cuda" else None)
        else:
            dst_stream = self.streams[dst]
        if src_stream is None:
            return x.to(device)
        with self.on(src):
            y = x.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(src_stream)
        if dst_stream is None:
            done.synchronize()
            return y
        dst_stream.wait_event(done)
        y.record_stream(dst_stream)
        return y

    def synchronize(self):
        """Wait until every entry's queued work is done."""
        for stream in self.streams:
            if stream is not None:
                stream.synchronize()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """This process's host tensor ``x`` concatenated with every other
        process's, in rank order (itself when there is one process).
        Every process gives a tensor of the same shape."""
        if self.world_size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)


def make_data_mesh(num_devices: int | None = None,
                   devices=None) -> DataMesh:
    """The mesh over ``devices`` (default ``config.mesh_devices()``:
    every visible CUDA device, or the engine's device when it is the
    CPU), cut to the first ``num_devices``.  In a process group
    (``maybe_initialize_distributed``) these are this process's own
    entries, by default its torchrun ``LOCAL_RANK``'s card, and every
    process must bring as many."""
    if devices is None:
        devices = config.mesh_devices()
        if dist.is_initialized() and os.environ.get("LOCAL_RANK") and \
                devices and devices[0].startswith("cuda"):
            devices = [devices[int(os.environ["LOCAL_RANK"])
                               % len(devices)]]
    devices = list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    if not devices:
        raise RuntimeError("CUDA is unavailable: no device for the mesh")
    if not dist.is_initialized():
        return DataMesh(devices)
    mesh = DataMesh(devices, dist.get_rank(), dist.get_world_size())
    counts = mesh.all_gather(torch.tensor([len(devices)]))
    if bool((counts != len(devices)).any()):
        raise ValueError(f"every process must bring as many mesh entries; "
                         f"they bring {counts.tolist()}")
    return mesh


def maybe_initialize_distributed() -> bool:
    """Join the process group when torchrun's variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) are all set; a no-op otherwise, or
    when the group is up already.  The backend is the default map
    ``cuda:nccl,cpu:gloo`` (``gloo`` without CUDA); the mesh's
    collectives move host tensors, so they take gloo.  Returns whether
    this process is in a group."""
    if dist.is_initialized():
        return True
    if not all(os.environ.get(name) for name in TORCHRUN_ENV):
        return False
    backend = "cuda:nccl,cpu:gloo" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend)
    return True
