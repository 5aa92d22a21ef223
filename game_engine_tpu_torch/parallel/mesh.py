"""Mesh construction and sharding rules.

Counterpart of game_engine_tpu/parallel/mesh.py. A JAX mesh is a grid of
devices under one program, and GSPMD inserts the collectives. Torch has no
virtual devices: a device of the mesh is a rank, one process of a
torch.distributed world, and the collectives are explicit calls:

  rooms      the leading axis of every GameState array, split over 'data':
             each rank steps its own rooms (state_sharding);
  trunk      the policy trunk's w{i} / b{i} split over 'model', Megatron's
             column/row split (params_sharding); parallel/tp.py holds its
             collectives;
  gradients  summed over the ranks that hold the same parameter slice and
             other rooms (Mesh.data_sum), so every such rank applies the
             same Adam step.

Rank r sits at (r // model_parallel, r % model_parallel), the order of
JAX's reshape. The mesh holds one process group per data row (the ranks
that share rooms and split the model: the tensor-parallel collectives)
and one per model column (the ranks that hold the same slice and split the
rooms: the data-parallel sums).

Backends and devices. On "cuda" the default backend is NCCL with one card
a rank (cuda:{local_rank}); NCCL refuses two ranks on one card, so asking
it for more local ranks than cards raises, naming backend="gloo". A rank
is bound to its card (cuda:{local_rank % cards}, torch.cuda.set_device)
before it joins the world (init_world), and NCCL is given that card, so
that its barriers and communicators use it; a mesh only checks the
binding. Gloo takes CUDA tensors in all_reduce, broadcast and all_gather
(checked on an H100), so ranks that share a card run over gloo with their
tensors on it.
Gloo's send and recv write a CUDA pointer to the socket and fail ("Bad
address"), so the point-to-point hops of train/pipeline.py stage through
pinned host memory under gloo. device="cpu" with gloo is the tests' path.
Every process group is made with a timeout, so a collective that hangs
fails instead.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.core.state import GameState

AXES = ("data", "model")
# every process group's timeout: a collective or a group's creation that
# waits longer fails
TIMEOUT_S = 120.0


def timeout_of(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_ranks_per_card(n_local: int, backend: str, device) -> None:
    """NCCL puts one rank on a card: raise for more local ranks than cards."""
    if backend == "nccl" and torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if n_local > cards:
            raise ValueError(
                f"NCCL puts one rank on a card: {n_local} ranks on this host, {cards} "
                f"card(s). Ranks that share a card run with backend=\"gloo\"")


def rank_device(device, backend: str, rank: int) -> torch.device:
    """The device of `rank` on `device`'s type: cuda:{local_rank} (the
    card's index modulo the cards, so gloo ranks may share one), or the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    check_ranks_per_card(local + 1, backend, device)
    return torch.device("cuda", local % torch.cuda.device_count())


def init_world(backend: str, rank: int, world_size: int, device, **init) -> torch.device:
    """Bind this process to its rank's card (rank_device: cuda:{local_rank %
    cards}, made torch's current device), then join the world
    (init_process_group with `init`'s init_method or store). NCCL is given
    the card (device_id), so its barriers and communicators use it from the
    start. Returns the card, or the CPU."""
    dev = rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        init["device_id"] = dev
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=init.pop("timeout", timeout_of(TIMEOUT_S)), **init)
    return dev


def check_bound(dev: torch.device, rank: int) -> None:
    """Raise unless this process is bound to `dev` (its rank's card)."""
    if dev.type == "cuda" and torch.cuda.current_device() != dev.index:
        raise RuntimeError(
            f"rank {rank} runs on cuda:{torch.cuda.current_device()}, its card is {dev}: join "
            "the world through parallel.launch.run_ranks, initialize_multihost or make_mesh, "
            "which bind a rank to its card first")


class Mesh:
    """A (data, model) grid of ranks.

    `devices` holds the world ranks of the grid; `coords` is this rank's
    (data, model) place in it, or None for a rank outside the mesh. A mesh
    made without process groups (row_groups None) slices (params_sharding,
    state_sharding) but cannot reduce.

    With `timing` set to a dict, every collective first waits for the
    card's queued work, then adds to timing["host_wait_ms"] that wait, to
    timing["collective_ms"] its own host time up to the card's end of it
    (under NCCL the NCCL kernels and the wait for the group's last rank),
    and to timing["collectives"] one."""

    def __init__(self, devices, rank: int, device=D.DEFAULT, backend: Optional[str] = None,
                 row_groups=None, col_groups=None):
        self.devices = np.asarray(devices, dtype=np.int64).reshape(np.shape(devices))
        if self.devices.ndim != 2:
            raise ValueError(f"a mesh is a (data, model) grid, not {self.devices.shape}")
        self.rank = int(rank)
        self.device = D.resolve(device)
        self.backend = backend
        self._rows = row_groups
        self._cols = col_groups
        hit = np.argwhere(self.devices == self.rank)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        self.timing: Optional[dict] = None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data_size}, model={self.model_size}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device}, backend={self.backend})")

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def data_size(self) -> int:
        return int(self.devices.shape[0])

    @property
    def model_size(self) -> int:
        return int(self.devices.shape[1])

    @property
    def member(self) -> bool:
        return self.coords is not None

    def _coords(self) -> tuple:
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.devices.tolist()}")
        return self.coords

    @property
    def data_index(self) -> int:
        return self._coords()[0]

    @property
    def model_index(self) -> int:
        return self._coords()[1]

    @property
    def data_group(self):
        """The ranks of this rank's model column: the same parameter slice,
        other rooms."""
        if self._cols is None:
            raise ValueError("this mesh has no process groups")
        return self._cols[self.model_index]

    @property
    def model_group(self):
        """The ranks of this rank's data row: the same rooms, other slices
        of the trunk."""
        if self._rows is None:
            raise ValueError("this mesh has no process groups")
        return self._rows[self.data_index]

    def room_rows(self, local: int) -> tuple:
        """(first, end, total) rows of this rank's `local` rooms in the
        mesh's whole batch (equal shares, in data order)."""
        lo = self.data_index * local
        return lo, lo + local, self.data_size * local

    # -- collectives -----------------------------------------------------------

    def _timed(self, t: torch.Tensor, call):
        if self.timing is None:
            return call()
        t0 = time.perf_counter()
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        t1 = time.perf_counter()
        out = call()
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        t2 = time.perf_counter()
        self.timing["host_wait_ms"] = self.timing.get("host_wait_ms", 0.0) + (t1 - t0) * 1e3
        self.timing["collective_ms"] = self.timing.get("collective_ms", 0.0) + (t2 - t1) * 1e3
        self.timing["collectives"] = self.timing.get("collectives", 0) + 1
        return out

    def _all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        if not t.is_contiguous():
            raise ValueError("a collective needs a contiguous tensor")
        self._timed(t, lambda: dist.all_reduce(t, group=group))
        return t

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` in place over the data group (the same parameter slice,
        other rooms); returns it."""
        return self._all_reduce(t, self.data_group)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` in place over the model group (the same rooms, other
        trunk slices); returns it."""
        return self._all_reduce(t, self.model_group)

    def _all_gather(self, t: torch.Tensor, group, dim: int) -> torch.Tensor:
        n = dist.get_world_size(group)
        src = t.detach().contiguous()
        is_bool = src.dtype == torch.bool
        if is_bool:
            src = src.to(torch.uint8)
        outs = [torch.empty_like(src) for _ in range(n)]
        self._timed(t, lambda: dist.all_gather(outs, src, group=group))
        out = torch.cat(outs, dim)
        return out.bool() if is_bool else out

    def data_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data group's pieces of `t`, concatenated on `dim` in data order."""
        return self._all_gather(t, self.data_group, dim)

    def model_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The model group's pieces of `t`, concatenated on `dim` in model order."""
        return self._all_gather(t, self.model_group, dim)


def mesh_over(grid, backend: Optional[str] = None, device=D.DEFAULT) -> Mesh:
    """A Mesh over a (data, model) grid of world ranks, with its process
    groups. Every rank of the world calls it, members or not: each
    new_group is a collective of the whole world."""
    device = D.resolve(device)
    grid = np.asarray(grid, dtype=np.int64)
    backend = backend or dist.get_backend()
    rank = dist.get_rank()
    dev = rank_device(device, backend, rank)
    check_bound(dev, rank)
    td = timeout_of(TIMEOUT_S)
    rows = [dist.new_group([int(r) for r in row], backend=backend, timeout=td) for row in grid]
    cols = [dist.new_group([int(r) for r in col], backend=backend, timeout=td)
            for col in grid.T]
    return Mesh(grid, rank, dev, backend, rows, cols)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              backend: Optional[str] = None, device=D.DEFAULT) -> Mesh:
    """('data', 'model') mesh over the first n_devices ranks of the world
    (all of them by default); model_parallel must divide n_devices.

    A process with no torch.distributed world gets a world of one (an
    in-process store) when it asks for one rank; more ranks need
    initialize_multihost in every process first, or parallel.launch."""
    device = D.resolve(device)
    if not dist.is_initialized():
        if (n_devices or 1) != 1:
            raise RuntimeError(f"make_mesh over {n_devices} ranks needs a torch.distributed "
                               "world: call initialize_multihost in every process, or start "
                               "the ranks with parallel.launch.run_ranks")
        init_world(backend or default_backend(device), 0, 1, device, store=dist.HashStore())
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} ranks, the world has {world}")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide {n}")
    return mesh_over(np.arange(n).reshape(n // model_parallel, model_parallel), backend,
                     device)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None,
                         device=D.DEFAULT, timeout: float = TIMEOUT_S) -> int:
    """Join a world of num_processes ranks (one call in every process,
    before any make_mesh): init_process_group over tcp://coordinator_address
    ("host:port" of rank 0). One process, or None, does nothing. Returns
    the world's size."""
    if num_processes is None or num_processes <= 1:
        return 1
    device = D.resolve(device)
    if coordinator_address is None or process_id is None:
        raise ValueError("a world of several processes needs coordinator_address and "
                         "process_id")
    init_world(backend or default_backend(device), process_id, num_processes, device,
               init_method=f"tcp://{coordinator_address}", timeout=timeout_of(timeout))
    return dist.get_world_size()


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def param_spec(name: str, ndim: int) -> tuple:
    """The mesh axis each dimension of a parameter is split over (JAX's
    rule, game_engine_tpu/parallel/mesh.py:45-60): even w{i} split their
    output features over 'model', odd w{i} their input features; even b{i}
    split over 'model', odd b{i} replicate; every other parameter
    replicates."""
    if name.startswith("w") and name[1:].isdigit() and ndim == 2:
        return (None, "model") if int(name[1:]) % 2 == 0 else ("model", None)
    if name.startswith("b") and name[1:].isdigit():
        return ("model",) if int(name[1:]) % 2 == 0 else (None,)
    return (None,) * ndim


def _part(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what}: {n} does not split evenly over {parts} ranks")
    k = n // parts
    return slice(index * k, (index + 1) * k)


def _take(mesh: Mesh, x: torch.Tensor, spec: tuple, what: str) -> torch.Tensor:
    idx = []
    for dim, axis in enumerate(spec):
        if axis == "data":
            idx.append(_part(x.shape[dim], mesh.data_size, mesh.data_index, what))
        elif axis == "model":
            idx.append(_part(x.shape[dim], mesh.model_size, mesh.model_index, what))
        else:
            idx.append(slice(None))
    return x[tuple(idx)]


def state_sharding(mesh: Mesh, state: GameState) -> GameState:
    """This rank's rooms of `state` (axis 0 split over 'data', in data
    order), copied onto the mesh's device."""
    return GameState(*(
        _take(mesh, x, ("data",) + (None,) * (x.dim() - 1), f"state.{f}").to(
            mesh.device, copy=True)
        for f, x in zip(GameState._fields, state)))


def params_sharding(mesh: Mesh, params: dict) -> dict:
    """This rank's slice of every parameter by param_spec, as new tensors on
    the mesh's device that require grad where the originals did."""
    out = {}
    for k, v in params.items():
        t = _take(mesh, v.detach(), param_spec(k, v.dim()), f"param {k}").to(
            mesh.device, copy=True).contiguous()
        out[k] = t.requires_grad_(v.requires_grad)
    return out


def replicate(mesh: Mesh, tree):
    """Every tensor of a tree (dict, list, tuple, NamedTuple) copied onto
    the mesh's device: each rank holds all of it."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device, copy=True)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(mesh, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree


def data_sums(mesh: Optional[Mesh], *xs: torch.Tensor) -> tuple:
    """The scalars `xs`, each summed over the mesh's data group in one
    collective; without a mesh, `xs` as they are."""
    if mesh is None:
        return xs
    return tuple(mesh.data_sum(torch.stack(xs)).unbind())


def psum_metrics(metrics: dict, mesh: Mesh) -> dict:
    """Each metric summed over its elements and over the data group, as
    floats (for logging: it waits for the card)."""
    keys = list(metrics)
    sums = torch.stack([torch.as_tensor(metrics[k], device=mesh.device).to(torch.float64).sum()
                        for k in keys])
    mesh.data_sum(sums)
    return dict(zip(keys, sums.tolist()))


def gather_state(mesh: Mesh, state: GameState) -> GameState:
    """The data group's rooms, all of them, on every rank of the group."""
    return GameState(*(mesh.data_gather(x, 0) for x in state))


def gather_params(mesh: Mesh, params: dict) -> dict:
    """The whole parameters from the model group's slices."""
    out = {}
    for k, v in params.items():
        spec = param_spec(k, v.dim())
        out[k] = (mesh.model_gather(v, spec.index("model")) if "model" in spec
                  else v.detach().clone())
    return out
