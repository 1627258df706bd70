"""Normal-distribution special functions, written as the JAX package's own
formulas (bayesnmf_tpu/ops/pallas_special.py:22-79).

``ndtri`` is Acklam's rational approximation, ``ndtr`` is Abramowitz-Stegun
7.1.26 and ``log_ndtr`` switches to a two-term asymptotic series below -4.

These are deliberately NOT ``torch.special.ndtri/ndtr/log_ndtr``. The JAX
fused-sweep kernel uses these formulas, and its ``log_ndtr`` is off by up to
2.7e-3 (absolute) just below -4, where the asymptotic series takes over
(ROADMAP queue 3 item 1). The hyper-sweep acceptance and the TruncNormal
log-densities feed on it, so parity with the reference needs the same formula
on both sides. The CUDA kernel (csrc/fused_sweeps.cu) carries the same
formulas as ``__device__`` functions.

All arithmetic stays in float32, like the reference.
"""

from __future__ import annotations

import torch

_SQRT2PI = 2.5066282746310002
_LOG_SQRT2PI = 0.9189385332046727
_TINY = 1.2e-38

# Acklam (2003) coefficients
_A = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
      1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
_B = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
      6.680131188771972e01, -1.328068155288572e01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
      -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
      3.754408661907416e00)
_P_LOW = 0.02425


def _tail(q):
    c1, c2, c3, c4, c5, c6 = _C
    d1, d2, d3, d4 = _D
    return (((((c1 * q + c2) * q + c3) * q + c4) * q + c5) * q + c6) / (
        (((d1 * q + d2) * q + d3) * q + d4) * q + 1.0)


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """Inverse standard normal CDF (Acklam), elementwise; p is clamped to
    [1.2e-38, 1 - 1.2e-7]."""
    a1, a2, a3, a4, a5, a6 = _A
    b1, b2, b3, b4, b5 = _B
    p = p.clamp(_TINY, 1.0 - 1.2e-7)
    x_low = _tail(torch.sqrt(-2.0 * torch.log(p.clamp_min(_TINY))))
    x_up = -_tail(torch.sqrt(-2.0 * torch.log((1.0 - p).clamp_min(_TINY))))
    q = p - 0.5
    r = q * q
    x_mid = (((((a1 * r + a2) * r + a3) * r + a4) * r + a5) * r + a6) * q / (
        ((((b1 * r + b2) * r + b3) * r + b4) * r + b5) * r + 1.0)
    return torch.where(p < _P_LOW, x_low,
                       torch.where(p > 1.0 - _P_LOW, x_up, x_mid))


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via A&S 7.1.26, |abs err| < 7.5e-8."""
    z = x.abs()
    t = 1.0 / (1.0 + 0.2316419 * z)
    poly = t * (0.319381530 + t * (-0.356563782 + t * (1.781477937 + t * (
        -1.821255978 + t * 1.330274429))))
    pdf = torch.exp(-0.5 * z * z) / _SQRT2PI
    upper = 1.0 - pdf * poly
    return torch.where(x >= 0, upper, 1.0 - upper)


def log_ndtr(x: torch.Tensor) -> torch.Tensor:
    """log of the standard normal CDF; below -4 the asymptotic series
    log Phi(x) ~ -x^2/2 - log(-x) - log sqrt(2 pi) + log1p(-1/x^2 + 3/x^4)."""
    safe_tail = x.clamp_max(-4.0)
    ix2 = 1.0 / (safe_tail * safe_tail)
    tail = (-0.5 * safe_tail * safe_tail - torch.log(-safe_tail) - _LOG_SQRT2PI
            + torch.log1p(-ix2 * (1.0 - 3.0 * ix2)))
    direct = torch.log(ndtr(x.clamp_min(-4.0)).clamp_min(1e-38))
    return torch.where(x < -4.0, tail, direct)
