"""The ("data", "tile") mesh on torch.distributed, one process a cell.

Port of gsplat_tpu/dist/mesh.py. Axes: `data` shards the camera batch (one
camera a row each step), `tile` splits each image into horizontal bands.
Where the JAX package lets one process own several devices, the port runs
one process (one rank) a mesh cell on one device: the world is exactly
data x tile ranks, rank = d * tile + t (the JAX layout
`np.asarray(devices).reshape(data, tile)`).

The backend is decided before init by a stated rule and never changed
after an error:
- nccl when the ranks run on CUDA and each has a card of its own;
- gloo when they run on the CPU, or when several ranks share one card.
  On a shared card the port's collectives (collectives.py) copy each CUDA
  tensor to a host tensor, run the gloo collective on it and copy the
  result back; gloo's own partial CUDA support is not used.
"Each has a card of its own" compares the ranks on this host with its
cards. torchrun says how many ranks a host runs (LOCAL_WORLD_SIZE); with
the JAX CLI's flags every rank writes its host name to the coordinator's
store before init and counts the ranks that share its own.

No counterparts: `enable_collective_overlap` sets XLA:TPU scheduler flags
(overlapping the gradient all-reduce with the backward is a perf item of
its own here, ROADMAP Queue 2); `replicated` / `data_sharded` are JAX
shardings (data.py places the tensors itself).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from gsplat_tpu_torch._device import resolve_device

DATA_AXIS = "data"
TILE_AXIS = "tile"

# set by initialize_distributed: the rule's decision, for the banner
_STATE: Dict[str, Any] = {}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name, "")
    return int(v) if v.strip() else None


def torchrun_env() -> bool:
    """True when torchrun (or another launcher) set RANK and WORLD_SIZE."""
    return _env_int("RANK") is not None and _env_int("WORLD_SIZE") is not None


def choose_backend(device_type: str, local_world: int, n_cards: int) -> str:
    """The backend rule: nccl for CUDA ranks with a card each, else gloo.
    local_world is the number of ranks on this host, n_cards its cards."""
    if device_type == "cuda" and local_world <= n_cards:
        return "nccl"
    return "gloo"


def host_layout(hosts: Sequence[str], rank: int) -> Tuple[int, int]:
    """(local rank, local world) of `rank` from every rank's host name: its
    place among the ranks on its own host, in rank order, and their count."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return mine.index(rank), len(mine)


def store_layout(store, rank: int, world: int, host: str) -> Tuple[int, int]:
    """host_layout over a rendezvous store: each rank writes its host name
    and reads every other rank's (a get waits until that rank has written)."""
    store.set(f"gsplat_host/{rank}", host)
    hosts = [store.get(f"gsplat_host/{r}").decode() for r in range(world)]
    return host_layout(hosts, rank)


def env_layout(world: int, device_type: str, n_cards: int) -> Tuple[int, int]:
    """(local rank, local world) from a launcher's LOCAL_RANK and
    LOCAL_WORLD_SIZE (torchrun sets both). Without LOCAL_WORLD_SIZE the
    layout is only known when the world fits on this host's cards; CUDA
    ranks beyond them raise, since the backend could not be chosen."""
    local_rank = _env_int("LOCAL_RANK") or 0
    local_world = _env_int("LOCAL_WORLD_SIZE")
    if local_world is None:
        if device_type == "cuda" and world > n_cards:
            raise ValueError(
                f"a world of {world} CUDA ranks and {n_cards} card(s) on this host, but no "
                "LOCAL_WORLD_SIZE: set it (and LOCAL_RANK) to the ranks this host runs, as "
                "torchrun does, so the backend rule can tell a card each from shared cards")
        local_world = world
    return local_rank, local_world


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """Join the process group -> this rank's device.

    The JAX package's three flags: coordinator_address (host:port) hosts
    the rendezvous store (on process 0), num_processes is the world size,
    process_id the rank; or, without them, torchrun's RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT / LOCAL_RANK / LOCAL_WORLD_SIZE (env:// init),
    the counterpart of JAX's autodetect. A no-op returning the device for
    one process. `device` (CUDA unless named; it raises without a card) is
    the device type of every rank; a CUDA rank takes card (local rank)
    modulo this host's card count and makes it current. The local rank and
    the ranks on this host come from LOCAL_RANK / LOCAL_WORLD_SIZE where
    the launcher sets them, else, with the flags, from the store
    (store_layout), else as env_layout says."""
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if num_processes is not None and num_processes > 1:
        if not coordinator_address:
            raise ValueError("num_processes > 1 needs --coordinator_address host:port")
        world, rank = int(num_processes), int(process_id)
        if not 0 <= rank < world:
            raise ValueError(f"process_id {rank} outside [0, {world})")
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0)
        if _env_int("LOCAL_WORLD_SIZE") is not None:
            local_rank, local_world = env_layout(world, dev.type, n_cards)
        else:
            local_rank, local_world = store_layout(store, rank, world, socket.gethostname())
        init = dict(store=store, world_size=world, rank=rank)
    elif torchrun_env():
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
        local_rank, local_world = env_layout(world, dev.type, n_cards)
        init = dict(init_method="env://", world_size=world, rank=rank)
    else:
        return dev
    backend = choose_backend(dev.type, local_world, n_cards)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, **init, **kw)
    _STATE.update(backend=backend, device=dev, local_world=local_world, n_cards=n_cards)
    return dev


def backend_banner() -> str:
    """The backend rule's decision, as rank 0's mesh banner prints it."""
    if not (dist.is_available() and dist.is_initialized()):
        return "one process, no process group"
    backend = dist.get_backend()
    world = dist.get_world_size()
    dev = _STATE.get("device")
    if backend == "nccl":
        return f"backend nccl ({world} rank(s), a CUDA card each)"
    if dev is not None and dev.type == "cuda":
        return (f"backend gloo ({_STATE['local_world']} ranks share {_STATE['n_cards']} "
                "CUDA card(s) a host: each collective is staged through host memory)")
    return f"backend gloo ({world} rank(s) on the CPU)"


def world_info():
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass
class Mesh:
    """One rank's view of the (data, tile) mesh: the axis sizes, this rank's
    coordinates (d, t), and the process groups of its tile row (same d),
    its data column (same t) and the world (None without a process group:
    every collective is then the identity)."""

    data: int
    tile: int
    d: int
    t: int
    rank: int
    tile_group: Any = None
    data_group: Any = None
    world_group: Any = None
    distributed: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, TILE_AXIS: self.tile}

    @property
    def size(self) -> int:
        return self.data * self.tile


def make_mesh(data: int = -1, tile: int = 1) -> Mesh:
    """Build the ("data", "tile") mesh over the process group (a 1x1 mesh
    without one). data=-1 takes world // tile. The world must be exactly
    data x tile ranks: one process a mesh cell. Every rank must call it (it
    creates the row and column groups collectively)."""
    world, rank = world_info()
    if data == -1:
        if world % tile:
            raise ValueError(f"world of {world} ranks is no multiple of tile_axis {tile}")
        data = world // tile
    if data * tile != world:
        raise ValueError(
            f"mesh {data}x{tile} over {world} rank(s): the port runs one process a mesh "
            f"cell, so the world size must equal data_axis * tile_axis ({data * tile})")
    d, t = divmod(rank, tile)
    mesh = Mesh(data=data, tile=tile, d=d, t=t, rank=rank)
    if not (dist.is_available() and dist.is_initialized()):
        return mesh
    mesh.distributed = True
    mesh.world_group = dist.group.WORLD
    # new_group is collective: every rank creates every group, in one order
    for dd in range(data):
        g = dist.new_group([dd * tile + tt for tt in range(tile)])
        if dd == d:
            mesh.tile_group = g
    for tt in range(tile):
        g = dist.new_group([dd * tile + tt for dd in range(data)])
        if tt == t:
            mesh.data_group = g
    return mesh


def local_data_rows(mesh: Mesh) -> list:
    """The data-axis rows this process feeds: its own row, one process a
    cell (the JAX package: every row any of its devices sits in)."""
    return [mesh.d]
