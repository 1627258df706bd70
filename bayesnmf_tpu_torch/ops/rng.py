"""Counter-based random streams, one per chain.

The JAX package gives every chain its own threefry key, carried in the
chain's state and split at every step (bayesnmf_tpu/parallel/chains.py:
19-26, models/gibbs.py:54, :87, :118-122). The port's counterpart is a
Philox4x32-10 stream (Salmon et al., SC'11) whose every number is a pure
function of

- the run's seed (the Philox key: its low and high 32 bits),
- the chain's uid (its index in the ensemble as created, kept through
  compaction; a single sampler's chain has uid 0),
- the iteration (0 for the initial draws),
- the draw site (``SITES``: one id per place in a step that draws) and, for
  the gamma draw's exact rejection loop only, the round,
- the element's index in the chain's one-process layout (all of G).

The counter of element ``e`` is (e // 4, site + (round << 8), iteration,
uid): one Philox block gives four uniforms, word ``e % 4``'s low 24 bits
``j`` mapped to max(j / 2^24, tiny), in [tiny, 1) as torch.rand floored
at float32's smallest normal (and jax.random.uniform(minval=tiny)). A
normal takes block e // 2 and its two words (2 (e % 2), 2 (e % 2) + 1) as
(u1, u2) of Box-Muller, sqrt(-2 log u1) cos(2 pi u2), computed in float64
and rounded to float32. Nothing else enters: not which chains are
resident, not the mesh's shape, not how many rejection rounds other
chains or elements needed, and not the device type. So compaction keeps
each surviving chain's draws, a mesh rank draws only its own block, and a
checkpoint resumes the same stream on either device type.

``philox_fill`` is the wrapper: CPU tensors run the plain version
(``philox_fill_reference``, int64 tensor arithmetic), CUDA tensors launch
csrc/rng.cu (one thread per Philox block, or per element under an index
map) or raise. The allocation kernel (csrc/allocation.cu) keeps its own
in-kernel Philox, keyed from (seed, iteration, site) by ``subkey`` with
the chain's uid in its counter.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
TINY = 1.1754944e-38    # float32's smallest normal: the uniforms' floor
_TWO_PI = 6.283185307179586

#: the draw sites: every place in an initial draw or a step that draws.
#: The initial draws run at iteration 0 and a step at its own iteration,
#: so a site may serve both.
SITES = {name: i for i, name in enumerate((
    "mu_p", "sq_p", "mu_e", "sq_e",          # truncnormal prior parameters
    "lambda_p", "lambda_e",                  # exponential prior's Lambda
    "beta_p", "alpha_p", "beta_e", "alpha_e",  # gamma prior's parameters
    "prior_P", "prior_E",                    # P, E from the prior
    "R", "A", "sigmasq",                     # rank, inclusion, Normal sigmasq
    "fused",                                 # the fused step's uniforms
    "eager_u", "eager_z",                    # the eager step's draws
    "stream_u", "stream_z",                  # the streaming step's draws
    "hyper_u", "hyper_z",                    # the exact hyper-sweep's noise
    "slice",                                 # the gamma prior's slice pass
    "gamma_P", "gamma_E",                    # conjugate P and E
    "sweep_P", "sweep_E",                    # a sweep's column uniforms
    "alloc",                                 # the allocation's Philox key
))}


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit words of m * x for m < 2^32 and int64 x in
    [0, 2^32) (a tensor or an int), in two 48-bit partial products so
    nothing overflows int64."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(ctr, k0, k1):
    """Philox4x32-10 on 32-bit words held in int64 tensors or Python ints:
    the counter's four words and the key's two, broadcast together. The
    same rounds as csrc/philox.cuh."""
    x0, x1, x2, x3 = ctr
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], x0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return x0, x1, x2, x3


def uniform_of(word: torch.Tensor) -> torch.Tensor:
    """The uniform of a 32-bit word: its low 24 bits j as
    max(j / 2^24, TINY), float32, in [TINY, 1)."""
    j = (word & 0xFFFFFF).to(torch.float32)
    return (j * 2.0 ** -24).clamp_min_(TINY)


def seed_key(seed: int) -> tuple[int, int]:
    """The Philox key of a seed: its low and high 32 bits."""
    s = int(seed) % 2 ** 64
    return s & _MASK32, s >> 32


def site_word(site: str, rnd: int = 0) -> int:
    """Counter word 1: the site's id and the rejection round."""
    return SITES[site] + (int(rnd) << 8)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def philox_fill_reference(uids, key, word1: int, it: int, n: int,
                          index=None, normal: bool = False):
    """The draw in plain PyTorch: (C, n) float32 on ``uids``' device,
    element e of chain c the uniform (``normal``: the normal) of counter
    (e // 4 (// 2), word1, it, uids[c]) under ``key``; with ``index`` (an
    int64 tensor of n element indices) element i is element index[i]."""
    per = 2 if normal else 4
    dev = uids.device
    i64 = dict(dtype=torch.int64, device=dev)
    C = uids.numel()
    if index is None:
        blk = torch.arange(-(-n // per), **i64)
    else:
        blk = index.to(dev) // per
    words = philox4x32_10(
        (blk.view(1, -1), int(word1), int(it) & _MASK32, uids.view(C, 1)),
        *key)
    words = [w.expand(C, blk.numel()) for w in words]
    if normal:
        pairs = [(words[0], words[1]), (words[2], words[3])]
        zs = []
        for a, b in pairs:
            u1 = uniform_of(a).double()
            u2 = uniform_of(b).double()
            zs.append((torch.sqrt(-2.0 * torch.log(u1))
                       * torch.cos(_TWO_PI * u2)).to(torch.float32))
        vals = torch.stack(zs, -1)
    else:
        vals = torch.stack([uniform_of(w) for w in words], -1)
    if index is None:
        return vals.reshape(C, -1)[:, :n].contiguous()
    pick = (index.to(dev) % per).view(1, -1, 1).expand(C, -1, 1)
    return vals.gather(-1, pick).squeeze(-1)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
# out uids index, n C, k0 k1 word1 it, normal, stream
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int] \
    + [ctypes.c_uint32] * 4 + [ctypes.c_int, _P]


def _launch(uids, key, word1, it, n, index, normal):
    from ._build import load_library

    lib = load_library()
    fn = lib.philox_fill_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    C = uids.numel()
    out = torch.empty(C, n, dtype=torch.float32, device=uids.device)
    with torch.cuda.device(uids.device):
        err = fn(out.data_ptr(), uids.data_ptr(),
                 None if index is None else index.data_ptr(), n, C,
                 key[0], key[1], word1, int(it) & _MASK32, int(normal),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"philox_fill kernel launch failed: cudaError "
                           f"{err}")
    philox_fill.launches += 1
    return out


def philox_fill(uids, key, word1: int, it: int, n: int, index=None,
                normal: bool = False):
    """(C, n) float32 uniforms (``normal``: normals) of the chains
    ``uids`` (a contiguous (C,) int64 tensor) at counter word ``word1``
    (``site_word``) and iteration ``it`` under ``key`` (``seed_key``);
    ``index``: an int64 tensor of the n element indices to draw, on the
    same device (default: elements 0..n-1). CPU tensors take the plain
    version; CUDA tensors launch csrc/rng.cu or raise."""
    if uids.dtype != torch.int64 or uids.dim() != 1 \
            or not uids.is_contiguous():
        raise ValueError("philox_fill: uids must be a contiguous (C,) int64 "
                         "tensor")
    if index is not None and (index.dtype != torch.int64
                              or index.device != uids.device
                              or tuple(index.shape) != (n,)
                              or not index.is_contiguous()):
        raise ValueError(f"philox_fill: index must be a contiguous ({n},) "
                         f"int64 tensor on {uids.device}")
    if uids.device.type == "cpu":
        return philox_fill_reference(uids, key, word1, it, n, index, normal)
    if uids.device.type == "cuda":
        return _launch(uids, key, word1, it, n, index, normal)
    raise ValueError(f"philox_fill: no path for device {uids.device}")


#: kernel launches since the count was last reset (CPU calls do not count)
philox_fill.launches = 0


# ---------------------------------------------------------------------------
# the streams of a run's chains
# ---------------------------------------------------------------------------


class ChainStreams:
    """The random streams of a run's resident chains: the seed, their uids
    ((C,) int64 on the run's device) and the iteration; on a mesh (``block``)
    a rank's chains and its columns [g0, g1) of the whole G.

    Every draw has the chain axis first, or none for a single chain
    (``c_dim=None``), and with ``g`` its last axis is G: this rank's
    columns on a mesh, each element drawn at its index in the one-process
    layout. A step takes ``at(its iteration)``; ``select`` follows a
    compaction; ``state`` / ``from_state`` carry the stream through a
    checkpoint as plain ints and one numpy array."""

    def __init__(self, seed: int, uids, it: int = 0, device="cpu"):
        self.seed = int(seed)
        self.key = seed_key(seed)
        self.all_uids = np.asarray(uids, np.int64).reshape(-1)
        self.uids = torch.as_tensor(self.all_uids, device=device)
        self.device = self.uids.device
        self.iter = int(it)
        self.mesh = None
        self.G = self.g0 = self.g1 = None
        self.c0, self.c1 = 0, self.all_uids.size
        self._index = {}

    def _copy(self, **kw):
        new = object.__new__(ChainStreams)
        new.__dict__.update(self.__dict__)
        new.__dict__.update(kw)
        return new

    def at(self, it: int) -> "ChainStreams":
        """The streams at iteration ``it``."""
        return self if int(it) == self.iter else self._copy(iter=int(it))

    def select(self, idx) -> "ChainStreams":
        """The streams of the chains ``idx`` (an index tensor or array over
        the resident chains), for compaction; not on a mesh block, whose
        owner rebuilds it from the whole."""
        if self.mesh is not None:
            raise ValueError("select: rebuild a mesh block from the whole "
                             "streams")
        idx = np.asarray(torch.as_tensor(idx).cpu(), np.int64)
        return ChainStreams(self.seed, self.all_uids[idx], self.iter,
                            self.device)

    def block(self, mesh, G: int, split_chains: bool = True):
        """This rank's streams on ``mesh``: its chains of the resident ones
        (all of them without ``split_chains``: one chain replicated over
        the chain axis) and its columns of ``G``."""
        from ..parallel.mesh import chain_block, g_block

        C = self.all_uids.size
        c0, c1 = chain_block(C, mesh) if split_chains else (0, C)
        g0, g1 = g_block(G, mesh)
        return self._copy(uids=self.uids[c0:c1].contiguous(), mesh=mesh,
                          G=G, g0=g0, g1=g1, c0=c0, c1=c1, _index={})

    @property
    def G_local(self):
        """This rank's column count (None off a mesh)."""
        return None if self.mesh is None else self.g1 - self.g0

    def state(self) -> dict:
        """The whole streams as plain values (the checkpoint's record)."""
        return {"seed": self.seed, "iter": self.iter,
                "uids": self.all_uids.copy()}

    @classmethod
    def from_state(cls, d: dict, device="cpu") -> "ChainStreams":
        return cls(d["seed"], d["uids"], d["iter"], device)

    def subkey(self, site: str) -> tuple[int, int]:
        """A Philox key of (seed, iteration, site), for a kernel that draws
        inside (the allocation's)."""
        w = philox4x32_10((self.iter & _MASK32, SITES[site], 0, 0),
                          *self.key)
        return int(w[0]), int(w[1])

    # -- index maps of a mesh block -----------------------------------------

    def _split(self) -> bool:
        return self.mesh is not None and self.g1 - self.g0 != self.G

    def _map(self, key, rows: int, tmap: np.ndarray, width: int):
        idx = self._index.get(key)
        if idx is None:
            idx = (np.arange(rows, dtype=np.int64)[:, None] * width
                   + tmap[None, :]).reshape(-1)
            idx = torch.as_tensor(idx, device=self.device)
            self._index[key] = idx
        return idx

    # -- draws ----------------------------------------------------------------

    def _fill(self, site, rnd, n, index, normal):
        return philox_fill(self.uids, self.key, site_word(site, rnd),
                           self.iter, n, index, normal)

    def _draw(self, site, shape, c_dim, g, rnd, normal):
        shape = tuple(int(s) for s in shape)
        if c_dim is None:
            if self.uids.numel() != 1:
                raise ValueError(f"a draw without a chain axis needs one "
                                 f"chain, the streams hold "
                                 f"{self.uids.numel()}")
            return self._draw(site, (1,) + shape, 0, g, rnd, normal)[0]
        if c_dim != 0:
            first = ((shape[c_dim],) + shape[:c_dim] + shape[c_dim + 1:])
            return self._draw(site, first, 0, g, rnd,
                              normal).movedim(0, c_dim)
        C, rest = shape[0], shape[1:]
        if C != self.uids.numel():
            raise ValueError(f"a draw of {C} chains from streams of "
                             f"{self.uids.numel()}")
        n = int(np.prod(rest))
        index = None
        if g and self._split():
            if rest[-1] != self.g1 - self.g0:
                raise ValueError(f"a G draw of {rest[-1]} columns on a "
                                 f"block of {self.g1 - self.g0}")
            index = self._map(("g", rest), n // rest[-1],
                              np.arange(self.g0, self.g1), self.G)
        return self._fill(site, rnd, n, index, normal).view(shape)

    def uniform(self, site: str, shape, c_dim=0, g: bool = False,
                rnd: int = 0) -> torch.Tensor:
        """Uniforms in [TINY, 1) of ``shape``: dim ``c_dim`` the chain axis
        (None: one chain, no axis), with ``g`` the last dim G; ``rnd`` the
        rejection round."""
        return self._draw(site, shape, c_dim, g, rnd, False)

    def normal(self, site: str, shape, c_dim=0, g: bool = False):
        """Standard normals of ``shape``, laid out as ``uniform``'s."""
        return self._draw(site, shape, c_dim, g, 0, True)

    def flat(self, site: str, lead, parts, normal: bool = False):
        """A draw ``lead + (T,)`` (``lead[0]`` the chain axis) whose last
        axis concatenates ``parts``, each (rows, cols, g): a row-major rows
        x cols block, its cols this rank's columns of G when ``g`` on a
        mesh; every element drawn at its index in the one-process layout."""
        lead = tuple(int(s) for s in lead)
        T = sum(r * c for r, c, _ in parts)
        if not self._split():
            return self._draw(site, lead + (T,), 0, False, 0, normal)
        C, mid = lead[0], int(np.prod(lead[1:]))
        pieces, off = [], 0
        for rows, cols, g in parts:
            width = self.G if g else cols
            if g:
                pieces.append(off + (np.arange(rows)[:, None] * width
                                     + np.arange(self.g0, self.g1)[None, :]
                                     ).reshape(-1))
            else:
                pieces.append(off + np.arange(rows * cols))
            off += rows * width
        tmap = (np.concatenate(pieces) if pieces
                else np.zeros(0, np.int64)).astype(np.int64)
        index = self._map(("flat", tuple(parts), mid), mid, tmap, off)
        if C != self.uids.numel():
            raise ValueError(f"a draw of {C} chains from streams of "
                             f"{self.uids.numel()}")
        return self._fill(site, 0, mid * T, index, normal).view(lead + (T,))
