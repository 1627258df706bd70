"""Multi-process runs: the ``torch.distributed`` bootstrap and a global mesh
whose g axis stays inside one host.

Port of bayesnmf_tpu/parallel/multihost.py. Layout doctrine as there: the
chain axis is data-parallel across hosts (independent chains never
communicate inside a step, so the only traffic between hosts is the
chunk-boundary gathers and checkpoint writes), and the g axis is split
within one host, so the sweeps' sums over G all-reduce over the host's
own links.

Each process calls :func:`initialize` once (under ``torchrun`` with no
arguments), builds one :func:`global_mesh` and passes it to
``GibbsSampler(mesh=...)`` or ``ChainEnsemble(mesh=...)``. One process per
card; two processes that share a card run over gloo (NCCL refuses a
shared card), with the cost of gloo's host copies.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as _mesh
from .mesh import Mesh, g_block, make_mesh

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def _pick_backend(world: int) -> str:
    """NCCL when every process of this host has a card of its own, gloo
    otherwise (two processes on one card, or no card)."""
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               local_device_ids=None) -> bool:
    """Join the default process group. Idempotent: True once joined.

    With ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id``: ``init_process_group`` on ``tcp://host:port``. With no
    arguments: the ``torchrun`` environment (RANK, WORLD_SIZE,
    MASTER_ADDR/MASTER_PORT), and without one a no-op that returns False
    (a single-process run, as the JAX package's off-cluster call).
    ``backend`` None picks NCCL when every process of the host has a card
    of its own and gloo otherwise, and says which on stderr. Every
    collective waits at most ``timeout``.

    ``local_device_ids`` (an id or a sequence of ids of this host's cards,
    as the JAX function takes them): the first is this process's card
    (``torch.cuda.set_device``), which its meshes and collectives then use
    in place of ``LOCAL_RANK % cards``; an id outside
    ``range(torch.cuda.device_count())`` raises ValueError. None keeps the
    ``LOCAL_RANK`` choice."""
    if dist.is_initialized():
        return True
    if local_device_ids is not None:
        ids = ([int(local_device_ids)] if np.ndim(local_device_ids) == 0
               else [int(i) for i in local_device_ids])
        n_cards = torch.cuda.device_count()
        bad = [i for i in ids if not 0 <= i < n_cards]
        if not ids or bad:
            raise ValueError(f"local_device_ids {ids}: this host has "
                             f"{n_cards} card(s), ids in range({n_cards})")
    if coordinator_address is None:
        env = os.environ
        if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            return False
        init_method = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if backend is None:
        backend = _pick_backend(world)
        if rank == 0:
            print(f"bayesnmf_tpu_torch: torch.distributed backend {backend} "
                  f"({world} processes, "
                  f"{torch.cuda.device_count()} card(s) on this host)",
                  file=sys.stderr, flush=True)
    if local_device_ids is not None:
        torch.cuda.set_device(ids[0])
        _mesh._bound_card = ids[0]
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    return True


def _host_ids() -> np.ndarray:
    """Every rank's host, as a hash of its host name, by one all_reduce."""
    world = dist.get_world_size()
    dev = (torch.device("cuda", _mesh.local_card(dist.get_rank()))
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.zeros(world, dtype=torch.float64, device=dev)
    t[dist.get_rank()] = float(zlib.crc32(socket.gethostname().encode()))
    dist.all_reduce(t)
    return t.cpu().numpy()


def n_hosts() -> int:
    """The number of distinct hosts (one process per card, so not the
    world size); 1 off-cluster."""
    if not dist.is_initialized():
        return 1
    return int(np.unique(_host_ids()).size)


def global_mesh(n_chain: Optional[int] = None, n_g: Optional[int] = None,
                device="cuda") -> Mesh:
    """A (chain, g) mesh over every rank of every host: the g axis inside
    one host, the chain axis across hosts. One host falls back to
    ``make_mesh``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    ids = _host_ids() if dist.is_initialized() else np.zeros(1)
    hosts = int(np.unique(ids).size)
    per_host = n // hosts
    if n_chain is None and n_g is None:
        n_chain, n_g = n, 1
    elif n_chain is None:
        n_chain = n // n_g
    elif n_g is None:
        n_g = n // n_chain
    if n_chain * n_g != n:
        raise ValueError(f"mesh {n_chain}x{n_g} != {n} global devices")
    if hosts == 1:
        return make_mesh(n_chain, n_g, device=device)
    if n_g > per_host or per_host % n_g != 0:
        raise ValueError(
            f"g axis ({n_g}) must divide one host's device count "
            f"({per_host}) so its collectives stay on one host")
    if n_chain % hosts != 0:
        raise ValueError(
            f"chain axis ({n_chain}) must be a multiple of the host count "
            f"({hosts}) for host-data-parallel chains")
    # ranks grouped by host, each host's ranks filling whole g rows
    order = sorted(range(n), key=lambda r: (ids[r], r))
    ranks = np.asarray(order).reshape(n_chain, n_g)
    return make_mesh(n_chain, n_g, ranks=ranks, device=device)


def shard_data(data, mesh: Mesh) -> torch.Tensor:
    """This rank's (K, G_local) block of the data on its device. Each
    process passes its full host copy (96 x G counts are small)."""
    data = np.asarray(data, np.float32)
    g0, g1 = g_block(data.shape[1], mesh)
    return torch.as_tensor(np.ascontiguousarray(data[:, g0:g1]),
                           device=mesh.device)
