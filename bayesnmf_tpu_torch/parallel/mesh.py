"""The (chain, g) grid of ranks and the layout of the sampler state on it.

Port of bayesnmf_tpu/parallel/mesh.py on ``torch.distributed``: one process
per rank, each holding one device. Chains are split over the ``chain`` axis
and the sample dimension G over the ``g`` axis, so that E, the data and
Mhat of one large fit live distributed. Where the JAX package lets GSPMD
insert the psums, each sum over G here is a local sum and one
``all_reduce`` over the rank's g group (``gsum``); everything else is
local, and the P side is computed alike on every rank of a g group from
the all-reduced sums.

A mesh run is a layout, not a different sampler: every rank seeds one
generator alike and makes every draw at its one-process shape, keeping its
block (``ShardGen``), so a run on a mesh gives the chains of the
one-process run with the same seed, up to the order of float sums.

Only ``all_reduce`` and ``broadcast`` are used on device tensors: they are
what gloo runs on CUDA tensors, and gloo is what two ranks on one card
need (NCCL refuses a card shared by two ranks).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

CHAIN_AXIS = "chain"
G_AXIS = "g"


class Mesh:
    """A (chain, g) grid of ranks of the default process group: ``ranks``
    (n_chain, n_g) global ranks, this process's coordinates (``ci``,
    ``gi``), its device, and the process groups of the whole grid
    (``group``), of its row (``g_group``: the ranks that share its chains
    and split G) and of its column (``chain_group``). A group of one rank
    is None: nothing is communicated over it."""

    def __init__(self, ranks: np.ndarray, device: torch.device):
        self.ranks = np.asarray(ranks, np.int64)
        self.n_chain, self.n_g = self.ranks.shape
        self.size = self.ranks.size
        self.device = device
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        pos = np.argwhere(self.ranks == self.rank)
        if pos.shape[0] != 1:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        self.ci, self.gi = (int(v) for v in pos[0])
        self.group = self.g_group = self.chain_group = None
        if self.size > 1:
            world = dist.get_world_size()
            # every rank of the world creates every group, in one order
            self.group = (None if self.size == world
                          else dist.new_group(self.ranks.ravel().tolist()))
            for i in range(self.n_chain):
                grp = (dist.new_group(self.ranks[i].tolist())
                       if self.n_g > 1 else None)
                if i == self.ci:
                    self.g_group = grp
            for j in range(self.n_g):
                grp = (dist.new_group(self.ranks[:, j].tolist())
                       if self.n_chain > 1 else None)
                if j == self.gi:
                    self.chain_group = grp

    @property
    def root(self) -> int:
        """The global rank that writes logs, plots and checkpoints."""
        return int(self.ranks[0, 0])

    @property
    def is_root(self) -> bool:
        return self.rank == self.root

    def __repr__(self):
        return (f"Mesh({self.n_chain}x{self.n_g}, rank {self.rank} at "
                f"({self.ci}, {self.gi}), {self.device})")


#: the card multihost.initialize(local_device_ids=...) bound this process
#: to, else None
_bound_card: Optional[int] = None


def local_card(rank: int) -> int:
    """This process's card: the one ``multihost.initialize`` bound it to,
    else ``local rank % cards``."""
    import os

    if _bound_card is not None:
        return _bound_card
    local = int(os.environ.get("LOCAL_RANK", rank))
    return local % torch.cuda.device_count()


def _device_of(rank: int, device) -> torch.device:
    """The device of a rank: the CPU when asked, else its card
    (``local_card``); no card is an error, not a quiet run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: device='cuda' but no card is "
                           "visible to this process")
    if dev.index is not None:
        return dev
    return torch.device("cuda", local_card(rank))


def make_mesh(n_chain: Optional[int] = None, n_g: Optional[int] = None,
              ranks=None, device="cuda") -> Mesh:
    """A (chain, g) mesh over ``ranks`` (default: every rank of the default
    process group, or this process alone when none is initialised),
    row-major. Defaults as the JAX package's: all ranks on the chain axis.
    ``device``: "cuda" (each rank's own card) or "cpu"."""
    if ranks is None:
        n_world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = np.arange(n_world)
    ranks = np.asarray(ranks, np.int64).ravel()
    n = ranks.size
    if n_chain is None and n_g is None:
        n_chain, n_g = n, 1
    elif n_chain is None:
        n_chain = n // n_g
    elif n_g is None:
        n_g = n // n_chain
    if n_chain * n_g != n:
        raise ValueError(f"mesh {n_chain}x{n_g} != {n} devices")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(ranks.reshape(n_chain, n_g), _device_of(rank, device))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def split(n: int, parts: int, i: int) -> tuple[int, int]:
    """Block ``i`` of ``parts`` over range(n): the first n % parts blocks
    one longer."""
    base, rem = divmod(n, parts)
    lo = i * base + min(i, rem)
    return lo, lo + base + (1 if i < rem else 0)


def g_block(G: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's columns [g0, g1) of G. Ragged G is allowed: the first
    G % n_g blocks are one longer."""
    if G < mesh.n_g:
        raise ValueError(f"G = {G} is smaller than the g axis ({mesh.n_g})")
    return split(G, mesh.n_g, mesh.gi)


def chain_block(C: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's chains [c0, c1) of C; C must be a multiple of the chain
    axis."""
    if C % mesh.n_chain:
        raise ValueError(f"n_chains ({C}) must be a multiple of the chain "
                         f"axis ({mesh.n_chain})")
    per = C // mesh.n_chain
    return mesh.ci * per, (mesh.ci + 1) * per


# ---------------------------------------------------------------------------
# layouts: which axis of each leaf is split over which mesh axis
# ---------------------------------------------------------------------------


def state_layout(spec, chains: bool = True) -> dict:
    """The layout of a (chain-batched) sampler state: per tensor leaf, a
    tuple naming the mesh axis each of its dims is split over (None:
    replicated); the same table as the JAX package's ``state_shardings``
    partition specs (its threefry key and iteration are no tensors here).
    Every G-sized trailing axis is split over ``g``, the leading chain axis
    over ``chain``; K and N axes are replicated."""
    c = (CHAIN_AXIS,) if chains else ()
    rep2 = c + (None, None)
    gcol = c + (None, G_AXIS)
    gvec = c + (G_AXIS,)
    params = {"P": rep2, "E": gcol, "A": c + (None,), "R": c}
    if spec.needs_Z:
        params["Zsum_g"] = rep2
        params["Zsum_k"] = gcol
    if spec.needs_sigmasq:
        params["sigmasq"] = gvec
    if spec.prior == "truncnormal":
        prior = {"Mu_p": rep2, "Sigmasq_p": rep2, "Mu_e": gcol,
                 "Sigmasq_e": gcol}
    elif spec.prior == "exponential":
        prior = {"Lambda_p": rep2, "Lambda_e": gcol}
    else:
        prior = {"Alpha_p": rep2, "Beta_p": rep2, "Alpha_e": gcol,
                 "Beta_e": gcol}
    if spec.needs_sigmasq:
        prior["Alpha_sig"] = gvec
        prior["Beta_sig"] = gvec
    state = {"params": params, "prior": prior}
    if spec.MH:
        state["acc_P"] = rep2
        state["acc_E"] = gcol
    return state


def sample_out_layout(spec, chains: bool = True, record: str = "basic",
                      store_E: bool = True) -> dict:
    """The layout of a chunk's records (the step axis after the chain axis,
    never split), mirroring what the step records for ``record``: the
    metrics rows; with 'basic' P, E and A; with 'full' also the prior
    parameters, sigmasq and the acceptance records; E dropped without
    ``store_E``. The same table as the JAX ``sample_out_shardings``."""
    c = (CHAIN_AXIS,) if chains else ()

    def ns(*axes):
        return c + (None,) + axes

    out = {"metrics": ns(None)}
    if record == "metrics":
        return out
    out |= {"P": ns(None, None), "E": ns(None, G_AXIS), "A": ns(None)}
    if record == "full":
        st = state_layout(spec, chains=chains)
        at = 1 if chains else 0
        out["prior"] = {k: v[:at] + (None,) + v[at:]
                        for k, v in st["prior"].items()}
        if spec.needs_sigmasq:
            out["sigmasq"] = ns(G_AXIS)
        if spec.MH:
            out["acc_P"] = ns(None, None)
            out["acc_E"] = ns(None, G_AXIS)
    if not store_E:
        del out["E"]
    return out


def _map(fn, tree, layout):
    """``fn(leaf, axes)`` over the tensor leaves of ``tree`` that
    ``layout`` names; everything else as it is."""
    if isinstance(tree, dict):
        return {k: (_map(fn, v, layout[k]) if k in layout else v)
                for k, v in tree.items()}
    return fn(tree, layout) if isinstance(tree, torch.Tensor) else tree


def local(x, layout, mesh: Mesh, G: int):
    """This rank's block of a full tensor (or of every leaf of a nested
    dict, ``layout`` the matching table): the chain axis narrowed to its
    chains, the g axis to its columns of G."""
    def cut(t, axes):
        for d, ax in enumerate(axes):
            if ax == CHAIN_AXIS:
                c0, c1 = chain_block(t.shape[d], mesh)
                t = t.narrow(d, c0, c1 - c0)
            elif ax == G_AXIS:
                g0, g1 = g_block(G, mesh)
                t = t.narrow(d, g0, g1 - g0)
        return t.contiguous()

    return _map(cut, x, layout)


def gather(x, layout, mesh: Mesh, G: int):
    """The full tensor from every rank's block (or every leaf of a nested
    dict), on every rank: one all_reduce of a zero-filled full buffer into
    which the one rank that owns each block (the first of its replicas)
    has written it. Used at chunk boundaries, never in a step."""
    def full(t, axes):
        if mesh.size == 1:
            return t
        shape = list(t.shape)
        index = []
        owner = True
        for d, ax in enumerate(axes):
            if ax == CHAIN_AXIS:
                n = t.shape[d] * mesh.n_chain
                shape[d] = n
                index.append(slice(*chain_block(n, mesh)))
            elif ax == G_AXIS:
                shape[d] = G
                index.append(slice(*g_block(G, mesh)))
            else:
                index.append(slice(None))
        if CHAIN_AXIS not in axes:
            owner &= mesh.ci == 0
        if G_AXIS not in axes:
            owner &= mesh.gi == 0
        wide = t.dtype if t.is_floating_point() else torch.float64
        buf = torch.zeros(shape, dtype=wide, device=t.device)
        if owner:
            buf[tuple(index)] = t.to(wide)
        dist.all_reduce(buf, group=mesh.group)
        return buf.to(t.dtype)

    return _map(full, x, layout)


# ---------------------------------------------------------------------------
# collectives of a step
# ---------------------------------------------------------------------------


def g_all_reduce(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Partial sums over this rank's columns of G added over its g group,
    in place; no collective at all with n_g == 1."""
    if mesh is not None and mesh.n_g > 1:
        dist.all_reduce(t, group=mesh.g_group)
    return t


def gsum(x: torch.Tensor, dim, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x.sum(dim)`` where ``dim`` runs over G: the local sum plus one
    all_reduce over the g group (none with n_g == 1)."""
    return g_all_reduce(torch.sum(x, dim), mesh)


def all_true(flag: torch.Tensor, mesh: Optional[Mesh]) -> bool:
    """``bool(flag.all())`` over every rank of the mesh: the ranks that
    share a generator take the same branch."""
    if mesh is None or mesh.size == 1:
        return bool(flag.all())
    t = (~flag).any().to(torch.float32).reshape(1)
    dist.all_reduce(t, group=mesh.group)
    return float(t.item()) == 0.0


def broadcast_object(obj, mesh: Optional[Mesh]):
    """The root rank's ``obj`` on every rank of the mesh."""
    if mesh is None or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.root, group=mesh.group,
                               device=(mesh.device if dist.get_backend(
                                   mesh.group) == "nccl" else None))
    return box[0]


def check_same(value, mesh: Optional[Mesh], what: str):
    """Raise unless every rank of the mesh holds ``value`` (a number or an
    array), e.g. a convergence decision taken from all-reduced rows."""
    if mesh is None or mesh.size == 1:
        return
    ref = broadcast_object(value, mesh)
    if not np.array_equal(np.asarray(ref), np.asarray(value)):
        raise RuntimeError(f"rank {mesh.rank}: {what} differs from rank "
                           f"{mesh.root}'s ({value!r} != {ref!r})")


# ---------------------------------------------------------------------------
# the shared generator
# ---------------------------------------------------------------------------


class ShardGen:
    """The generator of a mesh run: one ``torch.Generator`` seeded alike on
    every rank, which makes every draw at its one-process shape (all
    ``C`` chains, all ``G`` columns) and keeps this rank's block, so that
    every rank's generator stays in step with the one-process run's. The
    samplers of ops/distributions.py and models/updates.py take it in the
    place of a ``torch.Generator`` and draw through ``draw`` and
    ``draw_flat``; ``torch.rand(generator=...)`` refuses it, so a draw that
    does not go through them fails instead of drifting. ``split_chains``
    False (one chain replicated over the chain axis, the single sampler)
    keeps every chain."""

    def __init__(self, gen: torch.Generator, mesh: Mesh, C: int, G: int,
                 split_chains: bool = True):
        self.gen = gen
        self.mesh = mesh
        self.device = gen.device
        self.G = G
        self.g0, self.g1 = g_block(G, mesh)
        self.split_chains = split_chains
        self.set_chains(C)
        self._index = {}

    def set_chains(self, C: int):
        """The resident chain count (it changes when an ensemble compacts)."""
        self.C = C
        self.c0, self.c1 = (chain_block(C, self.mesh) if self.split_chains
                            else (0, C))

    @property
    def G_local(self) -> int:
        return self.g1 - self.g0

    def all_true(self, flag: torch.Tensor) -> bool:
        """``bool(flag.all())`` over every rank that shares the generator."""
        return all_true(flag, self.mesh)

    def get_state(self):
        return self.gen.get_state()

    def set_state(self, s):
        self.gen.set_state(s)

    def _full(self, shape, normal):
        f = torch.randn if normal else torch.rand
        return f(tuple(shape), generator=self.gen, device=self.device)

    def draw(self, shape, c_dim: Optional[int], g: bool = False,
             normal: bool = False) -> torch.Tensor:
        """This rank's block of a uniform (or normal) draw whose local shape
        is ``shape``: dim ``c_dim`` is the chain axis, and with ``g`` the
        last dim is G. Every draw of a step has a chain axis (one chain is
        a batch of one): a draw without one is refused, not made at a local
        shape that would put this rank's generator out of step."""
        if c_dim is None:
            raise ValueError("a draw on a mesh needs its chain axis")
        full = list(shape)
        full[c_dim] = self.C
        if g:
            full[-1] = self.G
        x = self._full(full, normal).narrow(c_dim, self.c0, self.c1 - self.c0)
        if g:
            x = x.narrow(-1, self.g0, self.g1 - self.g0)
        return x.contiguous()

    def draw_flat(self, lead, parts, normal: bool = False) -> torch.Tensor:
        """A draw of shape ``lead + (T,)`` (``lead[0]`` the chain axis)
        whose last axis is the concatenation of ``parts``: each (rows, cols,
        g), a row-major rows x cols block, its cols this rank's columns of
        G when ``g``. Returns this rank's ``lead + (T_local,)`` block."""
        key = tuple(parts)
        idx = self._index.get(key)
        off = 0
        pieces = []
        for rows, cols, g in parts:
            width = self.G if g else cols
            if idx is None:
                if g:
                    r = torch.arange(rows, dtype=torch.int64) * width
                    c = torch.arange(self.g0, self.g1, dtype=torch.int64)
                    pieces.append(off + (r.unsqueeze(1)
                                         + c.unsqueeze(0)).reshape(-1))
                else:
                    pieces.append(off + torch.arange(rows * cols,
                                                     dtype=torch.int64))
            off += rows * width
        if idx is None:
            idx = (torch.cat(pieces) if pieces
                   else torch.zeros(0, dtype=torch.int64)).to(self.device)
            self._index[key] = idx
        x = self._full((self.C,) + tuple(lead[1:]) + (off,), normal)
        x = x.narrow(0, self.c0, self.c1 - self.c0)
        return x.index_select(-1, idx)


def mesh_of(gen) -> Optional[Mesh]:
    """The mesh of a generator: a ShardGen's, else None."""
    return getattr(gen, "mesh", None)
