"""The port's special functions against the JAX package's formulas and
scipy, on the grids of tests/test_pallas.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesnmf_tpu.ops import pallas_special as ps
from bayesnmf_tpu_torch.ops import special

torch.set_num_threads(1)

GRIDS = {
    "ndtri": np.linspace(1e-6, 1 - 1e-6, 20001).astype(np.float32),
    "ndtr": np.linspace(-9, 9, 20001).astype(np.float32),
    "log_ndtr": np.linspace(-30, 8, 20001).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_matches_jax_formula(name):
    """Same formula on both sides: float32 agreement to rel 1e-6. The atol
    is one float32 ulp at 1.0 (6e-8): ndtr forms 1 - upper for x < 0, so a
    1-ulp difference between XLA's and PyTorch's exp reaches the result at
    that absolute size (4 of the 20001 ndtr points, 1 of the log_ndtr)."""
    x = GRIDS[name]
    got = getattr(special, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(ps, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=6e-8)


def test_ndtri_accuracy():
    p = GRIDS["ndtri"]
    got = special.ndtri(torch.from_numpy(p)).numpy()
    assert np.abs(got - st.norm.ppf(p.astype(np.float64))).max() < 5e-4


def test_ndtr_accuracy():
    x = GRIDS["ndtr"]
    got = special.ndtr(torch.from_numpy(x)).numpy()
    assert np.abs(got - st.norm.cdf(x)).max() < 5e-7


def test_log_ndtr_accuracy():
    x = GRIDS["log_ndtr"]
    got = special.log_ndtr(torch.from_numpy(x)).numpy()
    want = st.norm.logcdf(x.astype(np.float64))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert rel.max() < 1e-2, rel.max()


def test_keeps_float32():
    for name, x in GRIDS.items():
        assert getattr(special, name)(torch.from_numpy(x)).dtype == \
            torch.float32
