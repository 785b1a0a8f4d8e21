"""Process-group runtime (counterpart of auformer/core/mesh.py).

The JAX package is data parallel by GSPMD: one global program over a
device mesh, whose every reduction over the batch is a collective. The
port runs one process per GPU under ``torch.distributed`` (``torchrun``),
each holding its rows of every global batch, and makes the global program
by hand: the train step all-gathers the model's outputs and labels and
computes the global loss (``parallel/step.py``), BatchNorm in train mode
reduces its statistics across the ranks (``nn/blocks.py``), the random
draws are those of the global batch (``draw_rows``), and the trainable
gradients are SUM-all-reduced before the optimizer. A world of N then
computes the world-1 step on the global batch, up to the order of
reductions.

``make_mesh`` returns None without an initialized process group: every
code path then is the single-process one. Under a process group the
collectives run at any world size, 1 included. NCCL serves CUDA devices
and gloo the CPU (``maybe_init_distributed``); NCCL is never swapped for
gloo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from collections import Counter
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist


def parse_mesh_shape(spec: str, n_devices: int) -> dict[str, int]:
    """Parse "data:-1" or "data:4,model:2" into axis sizes; -1 = fill."""
    axes: dict[str, int] = {}
    fill_axis = None
    for part in spec.split(","):
        name, _, size = part.partition(":")
        size = int(size) if size else -1
        if size == -1:
            if fill_axis is not None:
                raise ValueError(f"multiple -1 axes in mesh spec {spec!r}")
            fill_axis = name.strip()
            axes[fill_axis] = -1
        else:
            axes[name.strip()] = size
    fixed = int(np.prod([s for s in axes.values() if s != -1])) if axes else 1
    if fill_axis is not None:
        if n_devices % max(fixed, 1) != 0:
            raise ValueError(f"{n_devices} devices not divisible by {fixed}")
        axes[fill_axis] = n_devices // max(fixed, 1)
    return axes


def data_world(spec: str, world: int) -> int:
    """The size of the ``data`` axis of ``spec`` over ``world`` processes,
    which must be all of them: nothing shards over another axis (a
    ``model`` axis larger than 1 raises, as nothing shards over it in the
    JAX package either)."""
    axes = parse_mesh_shape(spec, world)
    other = {k: v for k, v in axes.items() if k != "data" and v != 1}
    if other:
        raise ValueError(f"mesh spec {spec!r}: axes {other} larger than 1; "
                         "auformer_torch shards the batch over 'data' only "
                         "(no parameter sharding over a 'model' axis)")
    if axes.get("data", 1) != world:
        raise ValueError(f"mesh spec {spec!r} gives data={axes.get('data')} "
                         f"of {world} processes")
    return world


@dataclasses.dataclass
class Mesh:
    """One process's place in a data-parallel world: its ``rank`` of
    ``world``, its ``local_rank`` on the host, its ``device``, the
    process group's ``backend`` and ``group`` (None: the default group).
    ``counts`` tallies this process's collectives by kind, with their
    bytes (``<kind>_bytes``); a CUDA graph's replays do not add to it."""
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str
    group: object = None
    counts: Counter = dataclasses.field(default_factory=Counter)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch whose local batch is ``n``:
        rank r holds the r-th block of n rows."""
        return slice(self.rank * n, (self.rank + 1) * n)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.counts[kind] += 1
        self.counts[kind + "_bytes"] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, kind: str = "all_reduce"
                   ) -> torch.Tensor:
        """SUM ``t`` over the ranks, in place; returns it."""
        self._count(kind, t)
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(n, ...) on every rank -> (world * n, ...), rank r's rows at
        ``rows(n)``; no autograd (the caller splices its own rows back)."""
        t = t.detach().contiguous()
        self._count("all_gather", t)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """SUM the gradients of ``params`` over the ranks through one flat
        buffer (one collective). Every rank holds gradients for the same
        parameters: the step runs one program."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce(flat, "gradients")
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers into every rank's ``module``
        (on the mesh's device)."""
        for t in [*module.parameters(), *module.buffers()]:
            self._count("broadcast", t)
            dist.broadcast(t.data, src=0, group=self.group)

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl" and self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def check_mesh(mesh, device=None) -> None:
    """Raise unless ``mesh`` is None or a ``Mesh`` (on ``device`` when
    given)."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: a core.mesh.Mesh (make_mesh under "
                        "a process group) or None")
    device = None if device is None else torch.device(device)
    if device is not None and (device.type != mesh.device.type or (
            device.index is not None and device.index != mesh.device.index)):
        raise ValueError(f"the mesh's device {mesh.device} is not {device}")


def maybe_init_distributed(device, backend: str | None = None) -> bool:
    """Join the process group that ``torchrun`` (or ``multiproc``'s
    launcher) describes in the environment: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``. ``backend``: NCCL
    for a CUDA ``device``, gloo for the CPU, unless given. Returns False
    without that environment, True once a group is initialized (also
    when one already was)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                  "MASTER_PORT")):
        return False
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        # the device's communicator is made at init, not at the first
        # collective, which may be inside a CUDA graph's capture
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://",
                            rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]), **kwargs)
    return True


def make_mesh(spec: str = "data:-1", device=None) -> Mesh | None:
    """The ``Mesh`` of this process under an initialized process group
    (``spec`` must put the whole world on its ``data`` axis), else None:
    the single-process paths."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = data_world(spec, dist.get_world_size())
    rank = dist.get_rank()
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank=rank, world=world,
                local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                device=device, backend=dist.get_backend())


@contextlib.contextmanager
def process_group_scope():
    """Destroy, on the way out, the process group initialized inside the
    block (by ``maybe_init_distributed``); a group that was there before
    stays."""
    had = dist.is_available() and dist.is_initialized()
    try:
        yield
    finally:
        if not had and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def shard_batch(mesh: Mesh | None, batch: Mapping, device=None) -> dict:
    """This rank's rows (``Mesh.rows``) of the numeric entries of a global
    numpy ``batch``, as tensors on the mesh's device (``device`` without a
    mesh, and then every row)."""
    out = {}
    for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype.kind in ("U", "S", "O"):
            continue
        if mesh is not None:
            n = arr.shape[0] // mesh.world
            arr = arr[mesh.rows(n)]
        out[k] = torch.as_tensor(np.ascontiguousarray(arr)).to(
            mesh.device if mesh is not None else device)
    return out


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor],
              shape: Sequence[int], mesh: Mesh | None,
              dim: int = 0) -> torch.Tensor:
    """``draw(shape)``, where ``shape[dim]`` is this rank's batch: under a
    mesh, the draw of the global batch (``shape[dim] * world`` along
    ``dim``) and this rank's rows of it, so every rank takes the numbers
    that the world-1 step draws for those rows from the same generator
    (the JAX package draws each random number once for the global array
    and shards it). Without a mesh, ``draw(shape)``."""
    if mesh is None:
        return draw(tuple(shape))
    full = list(shape)
    n = full[dim]
    full[dim] = n * mesh.world
    return draw(tuple(full)).narrow(dim, mesh.rank * n, n)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
