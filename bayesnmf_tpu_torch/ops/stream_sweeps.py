"""Streaming reductions of the large-G MH sweeps: no (chains, K, G) tensor.

Port of bayesnmf_tpu/ops/pallas_stream_sweeps.py. Each function rebuilds
the Mhat tile from ``PA = P * A`` and an E tile and returns only reductions:

- ``pcol_stats`` / ``pcol_accept``: one P column's conditional sums over G
  (``_run`` with col=True);
- ``erow_stats`` / ``erow_accept``: one E row's sums over K (col=False);
- ``acol_delta``: loglik(A_n = 1) - loglik(A_n = 0) for one column;
- ``chain_metrics``: the four data-dependent sums of the metrics row.

The signatures and the pre-scaling contract are the JAX package's
(pallas_stream_sweeps.py:357-359): P-column functions take ``pn = A_n*P_n``
and ``prop = A_n*proposal`` with ``en`` raw; E-row functions take
``en = A_n*E_n`` and ``prop = A_n*proposal`` with ``pn`` raw. Every
per-chain operand may carry a leading chain axis C; ``data`` (K, G) is
shared by the chains.

On CUDA tensors the wrappers launch the hand-written kernels of
csrc/stream_sweeps.cu or raise; on CPU tensors they run the plain PyTorch
version below, which evaluates every per-element term in the kernel's order
and sums in float64, tile by tile, as the kernel does.

Tolerance between kernel and plain version on the card: rtol 1e-6 and
atol 1e-6 (``KERNEL_RTOL``/``KERNEL_ATOL``): each per-element term rounds
the same way in both, and the float64 sums differ only in their order, so
the float32 results differ by at most an ulp or two.
"""

from __future__ import annotations

import ctypes

import torch

_FLOOR = 1e-6
# a plain-version tile: bounds the (C, K, tile) temporaries on the CPU
_PLAIN_TILE = 4096
# a kernel tile: threads of an E-row block, and the G width of the E tile
# staged in shared memory
_KERNEL_TILE = 256
_SMEM_BYTES = 48 * 1024

KERNEL_RTOL = 1e-6
KERNEL_ATOL = 1e-6


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and what the kernels are checked
# against)
# ---------------------------------------------------------------------------


def _mhat_tile(PA, E_t):
    """Mhat tile (C, K, Gt) = sum_n PA[:, :, n] E_t[:, n, :], n in order, in
    float32: the kernel's loop, not torch.matmul."""
    Mh = PA[:, :, 0:1] * E_t[:, 0:1, :]
    for n in range(1, PA.shape[2]):
        Mh = Mh + PA[:, :, n:n + 1] * E_t[:, n:n + 1, :]
    return Mh


def _tiles(G):
    return [(g0, min(g0 + _PLAIN_TILE, G)) for g0 in range(0, G, _PLAIN_TILE)]


def _col_terms(data, Mh, en, pn, prop):
    """P-column per-element terms (C, K, Gt); pn/prop (C, K, 1), en
    (C, 1, Gt)."""
    if prop is None:
        inv = torch.reciprocal(Mh.clamp_min(_FLOOR))
        resid = data - (Mh - pn * en)
        return (resid * inv) * en, inv * (en * en)
    Mh_no = Mh - pn * en
    lam = Mh.clamp_min(_FLOOR)
    lam_new = (Mh_no + prop * en).clamp_min(_FLOOR)
    d = lam_new - lam
    invr = torch.reciprocal(lam_new)
    resid = data - Mh_no
    return (data * torch.log1p(d / lam) - d, (resid * invr) * en,
            invr * (en * en))


def _row_terms(data, Mh, en, pn, prop):
    """E-row per-element terms (C, K, Gt); pn (C, K, 1), en/prop
    (C, 1, Gt)."""
    if prop is None:
        inv = torch.reciprocal(Mh.clamp_min(_FLOOR))
        resid = data - (Mh - pn * en)
        return (resid * inv) * pn, inv * (pn * pn)
    Mh_no = Mh - pn * en
    lam = Mh.clamp_min(_FLOOR)
    lam_new = (Mh_no + pn * prop).clamp_min(_FLOOR)
    d = lam_new - lam
    invr = torch.reciprocal(lam_new)
    resid = data - Mh_no
    return (data * torch.log1p(d / lam) - d, (resid * invr) * pn,
            invr * (pn * pn))


def _sum64(x, dims):
    return x.sum(dims, dtype=torch.float64)


def run_reference(data, E, PA, en, pn, prop, col: bool):
    """Plain version of ``_run`` on chain-batched operands: returns the
    2 (stats) or 3 (accept) outputs, each (C, K) for a P column or (C, G)
    for an E row."""
    G = E.shape[2]
    pn3 = pn.unsqueeze(-1)
    acc = None
    outs_row = []
    for g0, g1 in _tiles(G):
        Mh = _mhat_tile(PA, E[:, :, g0:g1])
        en3 = en[:, None, g0:g1]
        d_t = data[:, g0:g1]
        if col:
            q = None if prop is None else prop.unsqueeze(-1)
            sums = [_sum64(x, -1) for x in _col_terms(d_t, Mh, en3, pn3, q)]
            acc = sums if acc is None else [a + s for a, s in zip(acc, sums)]
        else:
            q = None if prop is None else prop[:, None, g0:g1]
            outs_row.append([_sum64(x, -2)
                             for x in _row_terms(d_t, Mh, en3, pn3, q)])
    if col:
        return tuple(a.to(torch.float32) for a in acc)
    return tuple(torch.cat(parts, -1).to(torch.float32)
                 for parts in zip(*outs_row))


def acol_delta_reference(data, E, PA, en, pn, an):
    """Plain version of ``acol_delta``: (C,) deltas."""
    acc = torch.zeros(E.shape[0], dtype=torch.float64, device=E.device)
    pn3, an3 = pn.unsqueeze(-1), an.view(-1, 1, 1)
    for g0, g1 in _tiles(E.shape[2]):
        Mh = _mhat_tile(PA, E[:, :, g0:g1])
        contrib = pn3 * en[:, None, g0:g1]
        Mh_off = Mh - an3 * contrib
        lam_off = Mh_off.clamp_min(_FLOOR)
        lam_on = (Mh_off + contrib).clamp_min(_FLOOR)
        d = lam_on - lam_off
        acc = acc + _sum64(data[:, g0:g1] * torch.log1p(d / lam_off) - d,
                           (-2, -1))
    return acc.to(torch.float32)


def chain_metrics_reference(data, E, PA):
    """Plain version of ``chain_metrics``: four (C,) sums."""
    acc = None
    for g0, g1 in _tiles(E.shape[2]):
        Mh = _mhat_tile(PA, E[:, :, g0:g1])
        d_t = data[:, g0:g1]
        lam = Mh.clamp_min(_FLOOR)
        L = torch.log(lam)
        d = Mh - d_t
        sums = [_sum64(x, (-2, -1)) for x in
                (d_t * L, lam, d_t.clamp_min(1e-6) * L, d * d)]
        acc = sums if acc is None else [a + s for a, s in zip(acc, sums)]
    return tuple(a.to(torch.float32) for a in acc)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "stream_pcol_launch": [_P] * 8 + [_I] * 5 + [_P],
    "stream_erow_launch": [_P] * 7 + [_I] * 5 + [_P],
    "stream_acol_launch": [_P] * 8 + [_I] * 5 + [_P],
    "stream_metrics_launch": [_P] * 5 + [_I] * 5 + [_P],
}


def kernel_tile(K: int, N: int) -> int:
    """G width of a kernel's tile: 256, halved until PA and the E tile fit
    the 48 KB of shared memory a block gets without opting in."""
    gt = _KERNEL_TILE
    while gt > 32 and (K * N + N * gt) * 4 > _SMEM_BYTES:
        gt //= 2
    return gt


def _fn(name):
    from ._build import load_library

    fn = getattr(load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _call(name, *args):
    with torch.cuda.device(args[0].device):
        err = _fn(name)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                          else a for a in args],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def _n_tiles(G, gt):
    return -(-G // gt)


def _launch_run(data, E, PA, en, pn, prop, col):
    C, K, N = PA.shape
    G = E.shape[2]
    gt = kernel_tile(K, N)
    n_out = 2 if prop is None else 3
    dev = PA.device
    if col:
        scratch = torch.empty(C * _n_tiles(G, gt) * n_out * K,
                              dtype=torch.float64, device=dev)
        out = torch.empty(n_out, C, K, dtype=torch.float32, device=dev)
        _call("stream_pcol_launch", data, E, PA, en, pn, prop, scratch, out,
              C, K, N, G, gt)
    else:
        out = torch.empty(n_out, C, G, dtype=torch.float32, device=dev)
        _call("stream_erow_launch", data, E, PA, en, pn, prop, out, C, K, N,
              G, gt)
    return tuple(out)


def _launch_acol(data, E, PA, en, pn, an):
    C, K, N = PA.shape
    G = E.shape[2]
    gt = kernel_tile(K, N)
    scratch = torch.empty(C * _n_tiles(G, gt), dtype=torch.float64,
                          device=PA.device)
    out = torch.empty(C, dtype=torch.float32, device=PA.device)
    _call("stream_acol_launch", data, E, PA, en, pn, an, scratch, out, C, K,
          N, G, gt)
    return out


def _launch_metrics(data, E, PA):
    C, K, N = PA.shape
    G = E.shape[2]
    gt = kernel_tile(K, N)
    scratch = torch.empty(C * _n_tiles(G, gt) * 4, dtype=torch.float64,
                          device=PA.device)
    out = torch.empty(4, C, dtype=torch.float32, device=PA.device)
    _call("stream_metrics_launch", data, E, PA, scratch, out, C, K, N, G, gt)
    return tuple(out)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(fn, name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _batch(fn, data, E, PA, vectors):
    """Add the chain axis to unbatched operands, check everything, and say
    which path runs. ``vectors``: (name, tensor, per-chain length or None
    for a per-chain scalar)."""
    batched = PA.dim() == 3
    if not batched:
        E, PA = E.unsqueeze(0), PA.unsqueeze(0)
        vectors = [(n, None if t is None else t.reshape(1, -1) if ln
                    else t.reshape(1), ln) for n, t, ln in vectors]
    C, K, N = PA.shape
    G = E.shape[2]
    dev = PA.device
    _check(fn, "data", data, (K, G), dev)
    _check(fn, "E", E, (C, N, G), dev)
    _check(fn, "PA", PA, (C, K, N), dev)
    for name, t, ln in vectors:
        if t is not None:
            _check(fn, name, t, (C, ln) if ln else (C,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no path for device {dev}")
    return batched, E, PA, [t for _, t, _ in vectors]


def _run(data, E, PA, en, pn, prop, col: bool):
    """The four bodies of the JAX package's ``_run``. Returns (C, K)
    outputs for a P column (col=True) and (C, G) outputs for an E row, two
    without ``prop`` (stats) and three with it (lp, mu1_r, den_r)."""
    K, G = data.shape
    batched, E, PA, (en, pn, prop) = _batch(
        "stream_sweeps", data, E, PA,
        [("en", en, G), ("pn", pn, K), ("prop", prop, K if col else G)])
    if PA.device.type == "cpu":
        out = run_reference(data, E, PA, en, pn, prop, col)
    else:
        out = _launch_run(data, E, PA, en, pn, prop, col)
        _run.launches += 1
    return out if batched else tuple(o[0] for o in out)


#: kernel launches since the count was last reset (CPU calls do not count)
_run.launches = 0


def pcol_stats(data, E, PA, en, pn_scaled):
    """(mu1, den_raw) of one P column: sums over G of
    (data - Mhat_no_n)/sig * E_n and E_n^2/sig."""
    return _run(data, E, PA, en, pn_scaled, None, col=True)


def pcol_accept(data, E, PA, en, pn_scaled, prop_scaled):
    """(lp_row, mu1_r, den_raw_r) of one P column at the proposal."""
    return _run(data, E, PA, en, pn_scaled, prop_scaled, col=True)


def erow_stats(data, E, PA, en_scaled, pn):
    """(mu1, den_raw) of one E row: sums over K."""
    return _run(data, E, PA, en_scaled, pn, None, col=False)


def erow_accept(data, E, PA, en_scaled, pn, prop_scaled):
    """(lp_col, mu1_r, den_raw_r) of one E row at the proposal."""
    return _run(data, E, PA, en_scaled, pn, prop_scaled, col=False)


def acol_delta(data, E, PA, en, pn, an):
    """loglik(A_n = 1) - loglik(A_n = 0) for one inclusion column: a (C,)
    tensor (a scalar tensor without the chain axis)."""
    K, G = data.shape
    batched, E, PA, (en, pn, an) = _batch(
        "acol_delta", data, E, PA,
        [("en", en, G), ("pn", pn, K), ("an", an, None)])
    if PA.device.type == "cpu":
        out = acol_delta_reference(data, E, PA, en, pn, an)
    else:
        out = _launch_acol(data, E, PA, en, pn, an)
        acol_delta.launches += 1
    return out if batched else out[0]


acol_delta.launches = 0


def chain_metrics(data, E, PA):
    """(sum M log lam, sum lam, sum Mp log lam, sum (Mhat-M)^2), each (C,)
    (scalars without the chain axis), with lam = max(Mhat, 1e-6)."""
    batched, E, PA, _ = _batch("chain_metrics", data, E, PA, [])
    if PA.device.type == "cpu":
        out = chain_metrics_reference(data, E, PA)
    else:
        out = _launch_metrics(data, E, PA)
        chain_metrics.launches += 1
    return out if batched else tuple(o[0] for o in out)


chain_metrics.launches = 0


def reset_launch_counts():
    """Set every stream kernel's launch count to 0."""
    _run.launches = acol_delta.launches = chain_metrics.launches = 0
