"""fHOG-31 of the port (tpu_mot_torch.ops.hog) against the JAX package's
(tpu_mot.ops.hog) on the CPU.

Tolerance: atol 2e-6 on features of magnitude <= 0.4 (measured 4.6e-7):
both sides compute the same float32 formulas in the same order, but the
arctangent, the square roots and the 4x4 cell sums come from different
libraries (XLA against ATen), and the truncation at 0.2 and the periodic
bin distance pass their differences on unamplified.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mot.ops import hog as j_hog
from tpu_mot_torch.ops import hog as t_hog

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=2e-6)


def _patches(kind: str, t: int = 4, p: int = 64) -> np.ndarray:
    rng = np.random.default_rng({"random": 0, "textured": 1,
                                 "uniform": 2}[kind])
    if kind == "random":
        return rng.random((t, p, p)).astype(np.float32)
    if kind == "textured":
        # Blocky texture with rectangles' strong edges, as the fixtures'
        # objects have, plus mild noise.
        x = np.kron(rng.random((t, p // 8, p // 8)), np.ones((8, 8)))
        x[:, 20:44, 18] = 1.0
        x[:, 20, 18:46] = 0.0
        return np.clip(x + rng.normal(0, 0.01, x.shape), 0, 1).astype(
            np.float32)
    return np.full((t, p, p), 0.37, np.float32)


@pytest.mark.parametrize("kind", ["random", "textured", "uniform"])
def test_hog_matches_jax(kind):
    p = _patches(kind)
    got = t_hog.hog_features(torch.as_tensor(p), 4).numpy()
    want = np.asarray(j_hog.hog_features(jnp.asarray(p), 4))
    assert got.shape == want.shape == (4, t_hog.N_CHANNELS, 16, 16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    if kind == "uniform":
        # Zero gradient everywhere: zero energy, all-zero features.
        assert not np.any(got)
    else:
        assert np.abs(got).max() > 0.05


def test_hog_gradient_at_pi_and_other_cells():
    """A left-pointing gradient (atan2 = pi) lands in the bins next to the
    periodic seam as in JAX; cell sizes 2 and 8 and a non-square count of
    tracks agree too."""
    p = np.tile(np.linspace(1.0, 0.0, 32, dtype=np.float32), (3, 32, 1))
    p[1] = p[1].T                                   # vertical gradient
    for cell in (2, 4, 8):
        got = t_hog.hog_features(torch.as_tensor(p), cell).numpy()
        want = np.asarray(j_hog.hog_features(jnp.asarray(p), cell))
        np.testing.assert_allclose(got, want, **TOL)
    assert t_hog.N_CHANNELS == j_hog.n_channels() == 31
