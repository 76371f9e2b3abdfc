"""The fused KCF wrappers' plain versions (tpu_mot_torch.kernels.kcf:
detect_fused_ref, train_fused_ref, and the wrappers on CPU tensors)
against the JAX package's Pallas kernels run in interpret mode on the CPU
(tpu_mot.kernels.kcf.detect_fused / train_fused).

Tolerances, as tests/test_kcf_fused.py states them for the Pallas kernel
against the XLA chain: rtol 1e-4 with atol 1e-5 for the response, atol
5e-5 for the spectra (magnitudes up to ~25; the alphaf entries are
quotients y^/(k^+lambda) and differ most where k^ is small).  Inputs are
seeded NumPy features ~N(0, 0.09) handed to both packages; the model is
trained by each package from the same features.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mot.kernels import kcf as j_fused
from tpu_mot.ops import kcf as j_kcf
from tpu_mot.ops.cfloat import CF
from tpu_mot_torch import interop
from tpu_mot_torch.config import KCFConfig
from tpu_mot_torch.kernels import kcf as t_fused
from tpu_mot_torch.kernels import roi as roi_k
from tpu_mot_torch.ops import features as feat_ops
from tpu_mot_torch.ops import kcf as t_kcf
from tpu_mot_torch.tools import bench as bench_tool

torch.set_num_threads(1)

RESP = dict(rtol=1e-4, atol=1e-5)
SPEC = dict(rtol=1e-4, atol=5e-5)


def _jc(cf: CF) -> np.ndarray:
    return np.asarray(cf.re) + 1j * np.asarray(cf.im)


def _models(rng, t, c, s):
    """The same trained bank in both packages: JAX trains it, interop
    carries it over (so the comparison isolates the fused functions)."""
    feat0 = rng.standard_normal((t, c, s, s)).astype(np.float32) * 0.3
    yf = j_kcf.make_yf(s, 2.5, 0.125, backend="matmul")
    jm = j_kcf.train(jnp.asarray(feat0), yf, 0.2, 1e-4, backend="matmul")
    tm = t_kcf.KCFModel(
        xf=interop.cf_to_complex(jm.xf.re, jm.xf.im),
        alphaf=interop.cf_to_complex(jm.alphaf.re, jm.alphaf.im))
    return jm, tm, yf


SHAPES = [(1, 16), (3, 16), (31, 16), (1, 32), (3, 32), (31, 32)]


@pytest.mark.parametrize("c,s", SHAPES)
def test_detect_plain_matches_pallas_interpret(c, s):
    rng = np.random.default_rng(c * 100 + s)
    jm, tm, _ = _models(rng, 4, c, s)
    feat = rng.standard_normal((4, c, s, s)).astype(np.float32) * 0.3
    want = np.asarray(j_fused.detect_fused(jm, jnp.asarray(feat), 0.2,
                                           interpret=True))
    got = t_fused.detect_fused(tm, torch.as_tensor(feat), 0.2).numpy()
    np.testing.assert_allclose(got, want, **RESP)
    np.testing.assert_array_equal(
        got, t_fused.detect_fused_ref(tm, torch.as_tensor(feat), 0.2))


@pytest.mark.parametrize("c,s", SHAPES)
def test_train_plain_matches_pallas_interpret(c, s):
    rng = np.random.default_rng(c * 100 + s + 1)
    jm, tm, yf = _models(rng, 6, c, s)
    feat = rng.standard_normal((6, c, s, s)).astype(np.float32) * 0.3
    lr = np.array([0.0, 1.0, 0.075, 0.0, 0.075, 1.0], np.float32)
    want = j_fused.train_fused(jm, jnp.asarray(feat), yf, 0.2, 1e-4,
                               jnp.asarray(lr), interpret=True)
    tyf = interop.cf_to_complex(yf.re, yf.im)
    got = t_fused.train_fused(tm, torch.as_tensor(feat), tyf, 0.2, 1e-4,
                              torch.as_tensor(lr))
    np.testing.assert_allclose(got.xf.numpy(), _jc(want.xf), **SPEC)
    np.testing.assert_allclose(got.alphaf.numpy(), _jc(want.alphaf), **SPEC)
    # lr = 0 keeps the old model exactly, lr = 1 replaces it.
    assert torch.equal(got.xf[0], tm.xf[0])
    fresh = t_kcf.train(torch.as_tensor(feat), tyf, 0.2, 1e-4)
    assert torch.equal(got.xf[1], fresh.xf[1])


def test_fused_roundtrip_tracks_shift():
    """tests/test_kcf_fused.py's round trip on the port: train from an
    empty bank at lr = 1, detect on a circularly shifted copy; the peak
    sits at the shift."""
    rng = np.random.default_rng(2)
    s = 32
    patch = rng.standard_normal((s, s)).astype(np.float32)
    yf = t_kcf.make_yf(s, 2.5, 0.125)
    empty = t_kcf.KCFModel(
        xf=torch.zeros((1, 1, s, s // 2 + 1), dtype=torch.complex64),
        alphaf=torch.zeros((1, s, s // 2 + 1), dtype=torch.complex64))
    model = t_fused.train_fused(empty, torch.as_tensor(patch[None, None]), yf,
                                0.2, 1e-4, torch.ones(1))
    shifted = np.roll(np.roll(patch, 3, axis=0), -2, axis=1)
    resp = t_fused.detect_fused(model, torch.as_tensor(shifted[None, None]),
                                0.2)
    dy, dx, peak, _ = t_kcf.peak_displacement(resp)
    assert abs(float(dy[0]) - 3) < 0.5, float(dy[0])
    assert abs(float(dx[0]) + 2) < 0.5, float(dx[0])
    assert float(peak[0]) > 0.5


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_detect_scales_auto_matches_jax(impl):
    """search's responses over [3, T] against JAX's detect_scales_auto:
    scale-major items against one bank (the fused path reads model row
    item % T, JAX tiles the model)."""
    rng = np.random.default_rng(5)
    c, s, t = 31, 16, 4
    jm, tm, _ = _models(rng, t, c, s)
    feat = rng.standard_normal((3, t, c, s, s)).astype(np.float32) * 0.3
    want = np.asarray(j_kcf.detect_scales_auto(jm, jnp.asarray(feat), 0.2,
                                               impl=impl))
    got = t_kcf.search(tm, torch.as_tensor(feat), 0.2, torch.ones(3),
                       impl=impl).response.numpy()
    assert got.shape == (3, t, s, s)
    np.testing.assert_allclose(got, want, **RESP)


def _jax_search(jm, feat, wts, impl):
    """JAX's own composition of the scale search: detect_scales_auto,
    peak_displacement over the [K*T] responses, the weighted argmax over
    the scales, and the PSR of the unit-scale response."""
    k, t = feat.shape[:2]
    resp = j_kcf.detect_scales_auto(jm, jnp.asarray(feat), 0.2, impl=impl)
    dys, dxs, peaks = (x.reshape(k, t) for x in j_kcf.peak_displacement(
        resp.reshape((k * t,) + resp.shape[2:])))
    best = jnp.argmax(peaks * jnp.asarray(wts)[:, None], axis=0)
    pick = lambda x: jnp.take_along_axis(x, best[None], axis=0)[0]
    unit = k // 2
    psr = j_kcf.psr(resp[unit], peaks[unit])
    return [np.asarray(x) for x in (pick(dys), pick(dxs), pick(peaks), best,
                                    resp, psr)]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("k", [1, 3])
def test_search_matches_jax_composition(k, impl):
    """ops/kcf.search at K = 1 (unit scale) and K = 3 on the CPU against
    the JAX package's composition on the same inputs; "pallas" runs K4's
    plain version and returns no spectra, the chain returns its own."""
    rng = np.random.default_rng(20 + k)
    c, s, t = 3, 16, 6
    jm, tm, _ = _models(rng, t, c, s)
    feat = rng.standard_normal((k, t, c, s, s)).astype(np.float32) * 0.3
    vals, _, wts = t_kcf.search_scales(1.0 if k == 1 else 1.05, 0.95, "cpu")
    assert len(vals) == k
    dy, dx, peak, best, resp, psr = _jax_search(jm, feat, wts.numpy(), impl)
    tfeat = torch.as_tensor(feat)
    got = t_kcf.search(tm, tfeat, 0.2, wts, impl=impl)
    np.testing.assert_allclose(got.response.numpy(), resp, **RESP)
    np.testing.assert_array_equal(got.best.numpy(), best)
    np.testing.assert_array_equal(
        got.idx.numpy(), resp.reshape(k, t, -1).argmax(axis=-1))
    np.testing.assert_allclose(got.peak.numpy(), peak, **RESP)
    for g, w in ((got.dy, dy), (got.dx, dx)):
        np.testing.assert_allclose(g.numpy(), w, **RESP)
    unit = k // 2
    np.testing.assert_allclose(
        t_kcf.psr(got.response[unit], got.peaks[unit],
                  got.idx[unit]).numpy(), psr, **RESP)
    if impl == "pallas":
        assert got.zf is None
        assert torch.equal(got.response.reshape(k * t, s, s),
                           t_fused.detect_fused_ref(
                               tm, tfeat.reshape(k * t, c, s, s), 0.2))
    else:
        assert torch.equal(got.zf, torch.fft.rfft2(tfeat))
        assert torch.equal(got.response, t_kcf.detect(tm, tfeat, 0.2))


def test_dispatch_and_cpu_wrappers_launch_nothing():
    rng = np.random.default_rng(6)
    _, tm, yf = _models(rng, 2, 3, 16)
    tyf = interop.cf_to_complex(yf.re, yf.im)
    feat = torch.as_tensor(
        rng.standard_normal((4, 3, 16, 16)).astype(np.float32) * 0.3)
    counts = (t_fused.launches_detect, t_fused.launches_train)
    ones = torch.ones(1)
    assert torch.equal(
        t_kcf.search(tm, feat[None, :2], 0.2, ones, "pallas").response[0],
        t_fused.detect_fused_ref(tm, feat[:2], 0.2))
    # "auto" resolves to the FFT chain, as in the JAX package
    assert torch.equal(
        t_kcf.search(tm, feat[None, :2], 0.2, ones, "auto").response[0],
        t_kcf.detect(tm, feat[:2], 0.2))
    lr = torch.tensor([0.5, 1.0])
    for impl in ("pallas", "auto"):
        got = t_kcf.train_blend_auto(tm, feat[:2], tyf, 0.2, 1e-4, lr, impl)
        want = t_fused.train_fused_ref(tm, feat[:2], tyf, 0.2, 1e-4, lr)
        assert torch.equal(got.xf, want.xf)
    with pytest.raises(ValueError, match="multiple"):
        t_fused.detect_fused(tm, feat[:3], 0.2)
    assert (t_fused.launches_detect, t_fused.launches_train) == counts


# ---- numpy mirror of the CUDA kernel's S = 16 schedule -------------------
# The kernel builds no table at run time: its twiddles are three constants
# and its output order the base-4 digit reversal REV16, both mirrored in
# tpu_mot_torch.kernels.kcf.  S = 16 is the only size with FFTs in
# registers; every other size runs the direct DFTs.

MIRROR_TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _max_rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft16_mirror_matches_numpy(dtype, inverse):
    rng = np.random.default_rng(7)
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    z = (rng.standard_normal((40, 16))
         + 1j * rng.standard_normal((40, 16))).astype(ctype)
    got = t_fused.fft16_mirror(z, inverse)
    assert got.dtype == ctype
    assert sorted(t_fused.REV16) == list(range(16))
    assert all(t_fused.REV16[t_fused.REV16[k]] == k for k in range(16))
    z64 = z.astype(np.complex128)
    want = np.fft.ifft(z64) * 16 if inverse else np.fft.fft(z64)
    assert _max_rel(got[..., list(t_fused.REV16)], want) <= MIRROR_TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rfft2_and_irfft2_mirrors_match_numpy(dtype):
    """Rows in pairs through one complex FFT, then columns; and back."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 3, 16, 16)).astype(dtype)
    spec = t_fused.rfft2_16_mirror(x)
    want = np.fft.rfft2(x.astype(np.float64))
    assert spec.shape == (6, 3, 16, 9)
    assert _max_rel(spec, want) <= MIRROR_TOL[dtype]
    back = t_fused.irfft2_16_mirror(spec)
    assert back.dtype == dtype
    assert _max_rel(back, x) <= 2 * MIRROR_TOL[dtype]
    # a spectrum that is not exactly Hermitian: the imaginary parts of DC
    # and Nyquist are dropped, as numpy's irfft2 drops them
    noisy = (want + 1e-3 * (rng.standard_normal(want.shape)
                            + 1j * rng.standard_normal(want.shape)))
    noisy = noisy.astype(spec.dtype)
    ref = np.fft.irfft(np.fft.ifft(noisy.astype(np.complex128), axis=-2),
                       n=16, axis=-1)
    assert _max_rel(t_fused.irfft2_16_mirror(noisy),
                    ref) <= 2 * MIRROR_TOL[dtype]


def test_reduce_scatter_mirror_sums_over_lanes():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((32, 32)).astype(np.float32)
    got = t_fused.reduce_scatter_mirror(q)
    np.testing.assert_allclose(got, q.astype(np.float64).sum(axis=0),
                               rtol=0, atol=2e-5)
    # integers sum exactly: entry l is the total of float l, nothing else
    k = np.arange(32 * 32, dtype=np.float32).reshape(32, 32)
    np.testing.assert_array_equal(t_fused.reduce_scatter_mirror(k),
                                  k.sum(axis=0))


@pytest.mark.parametrize("c", [1, 3, 31, 32])
def test_detect_fft16_mirror_matches_plain_version(c):
    """The S = 16 path stage by stage in float32 (feature-side energy,
    reduce-scatter channel sum, paired rows) against detect_fused_ref, at
    the card tests' tolerance of 1e-4 of the largest magnitude; 3 scales
    of items against a bank of 4 rows."""
    rng = np.random.default_rng(20 + c)
    _, tm, _ = _models(rng, 4, c, 16)
    feat = rng.standard_normal((12, c, 16, 16)).astype(np.float32) * 0.3
    want = t_fused.detect_fused_ref(tm, torch.as_tensor(feat), 0.2).numpy()
    got = t_fused.detect_fft16_mirror(tm.xf.numpy(), tm.alphaf.numpy(),
                                      feat, 0.2)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _max_rel(got, want) <= 1e-4


def test_reduce_scatter_mirror_real_half():
    """K5's channel sum: 16 floats per lane; lane l ends with the total of
    float l % 16 over all 32 lanes (the two half-warps exchange last)."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((32, 16)).astype(np.float32)
    got = t_fused.reduce_scatter_mirror(q)
    want = np.tile(q.astype(np.float64).sum(axis=0), 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[:16], got[16:])
    k = np.arange(32 * 16, dtype=np.float32).reshape(32, 16)
    np.testing.assert_array_equal(t_fused.reduce_scatter_mirror(k),
                                  np.tile(k.sum(axis=0), 2))


@pytest.mark.parametrize("c", [1, 3, 31, 32])
def test_train_fft16_mirror_matches_plain_version(c):
    """K5's S = 16 path stage by stage in float32 (feature-side energy,
    half-width reduce-scatter, paired rows, divide, blend) against
    train_fused_ref, relative to the largest magnitude.  xf 1e-5: x^ is one
    rfft2 and a blend, so only the FFT's float32 rounding separates the
    two.  alphaf 1e-3 (the card tests' tolerance): the Gaussian's exp of a
    near-zero energy difference and the divide by k^ + lambda amplify that
    rounding.  lr = 0 returns the old model exactly and lr = 1 the new one
    alone."""
    rng = np.random.default_rng(40 + c)
    t = 8
    _, tm, yf = _models(rng, t, c, 16)
    tyf = interop.cf_to_complex(yf.re, yf.im)
    feat = rng.standard_normal((t, c, 16, 16)).astype(np.float32) * 0.3
    lr = np.tile(np.array([1.0, 0.075, 0.0, 0.5], np.float32), t // 4)
    want = t_fused.train_fused_ref(tm, torch.as_tensor(feat), tyf, 0.2, 1e-4,
                                   torch.as_tensor(lr))
    xf, alphaf = t_fused.train_fft16_mirror(
        tm.xf.numpy(), tm.alphaf.numpy(), feat, tyf.numpy(), 0.2, 1e-4, lr)
    assert xf.dtype == alphaf.dtype == np.complex64
    assert xf.shape == (t, c, 16, 9) and alphaf.shape == (t, 16, 9)
    assert _max_rel(xf, want.xf.numpy()) <= 1e-5
    assert _max_rel(alphaf, want.alphaf.numpy()) <= 1e-3
    # lr = 0 (rows 2, 6): the old model, bit for bit
    np.testing.assert_array_equal(xf[2::4], tm.xf.numpy()[2::4])
    np.testing.assert_array_equal(alphaf[2::4], tm.alphaf.numpy()[2::4])
    # lr = 1 (rows 0, 4): the fresh model alone, whatever the old one was
    other, _ = t_fused.train_fft16_mirror(
        np.zeros_like(tm.xf.numpy()), np.zeros_like(tm.alphaf.numpy()), feat,
        tyf.numpy(), 0.2, 1e-4, lr)
    np.testing.assert_array_equal(xf[0::4], other[0::4])
    fresh = t_kcf.train(torch.as_tensor(feat), tyf, 0.2, 1e-4)
    assert _max_rel(xf[0::4], fresh.xf.numpy()[0::4]) <= 1e-5


# ---- K6: detect-site training at S = 64 (the mirror, the route) ----------
# K6's 64-point FFT is an 8 x 8 schedule over a group of 8 lanes with the
# float64-derived twiddles of kernels/kcf._twiddles; the mirror repeats it
# and K6's four passes in numpy.

def _shift_case(seed, t=12, s=64):
    """A bank trained on seeded features, the spectra of others; shifts 0,
    fractional and just inside +-S/4 (the stage's guard) on each axis."""
    rng = np.random.default_rng(seed)
    feat0 = torch.as_tensor(
        rng.standard_normal((t, 1, s, s)).astype(np.float32) * 0.3)
    yf = t_kcf.make_yf(s, 2.5, 0.125)
    model = t_kcf.KCFModel(*[x.contiguous() for x in
                             t_kcf.train(feat0, yf, 0.2, 1e-4)])
    zf = torch.fft.rfft2(torch.as_tensor(
        rng.standard_normal((t, 1, s, s)).astype(np.float32) * 0.3))
    edge = s / 4 - 1e-3
    dy = torch.tensor([0.0, 0.5, -edge, edge, 3.3, -7.25, 0.0, 1.0, 2.0,
                       -3.0, 1e-3, -0.4][:t])
    dx = torch.tensor([0.0, -0.5, edge, -edge, -2.2, 7.75, 0.25, 0.0, -2.0,
                       3.0, 0.3, 8.0][:t])
    return model, zf, dy, dx, yf


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft64_mirror_matches_numpy(dtype, inverse):
    rng = np.random.default_rng(11)
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    z = (rng.standard_normal((40, 64))
         + 1j * rng.standard_normal((40, 64))).astype(ctype)
    got = t_fused.fft64_mirror(z, inverse)
    assert got.dtype == ctype and got.shape == z.shape
    z64 = z.astype(np.complex128)
    want = np.fft.ifft(z64) * 64 if inverse else np.fft.fft(z64)
    assert _max_rel(got, want) <= MIRROR_TOL[dtype]


@pytest.mark.parametrize("rate", [0.0, 0.075, 1.0])
def test_train_shift_mirror_matches_plain_version(rate):
    """K6's passes in numpy float32 against train_shift_fused_ref, relative
    to the largest magnitude: xf 1e-6 (the shift and blend are the same
    roundings; numpy's and torch's float32 sin and cos may part by an
    ulp), alphaf 1e-5 (the FFT schedules round differently, amplified by
    the exp and the divide; 5e-7 seen).  lr = 0 keeps the old model
    exactly."""
    model, zf, dy, dx, yf = _shift_case(30)
    lr = torch.full((zf.shape[0],), rate)
    want = t_fused.train_shift_fused_ref(model, zf, dy, dx, yf, 0.2, 1e-4,
                                         lr, 64)
    xf, alphaf = t_fused.train_shift_fused_mirror(
        model.xf.numpy(), model.alphaf.numpy(), zf.numpy(), dy.numpy(),
        dx.numpy(), yf.numpy(), 0.2, 1e-4, lr.numpy())
    assert xf.dtype == alphaf.dtype == np.complex64
    assert xf.shape == (12, 1, 64, 33) and alphaf.shape == (12, 64, 33)
    assert _max_rel(xf, want.xf.numpy()) <= 1e-6
    assert _max_rel(alphaf, want.alphaf.numpy()) <= 1e-5
    if rate == 0.0:
        np.testing.assert_array_equal(xf, model.xf.numpy())
        np.testing.assert_array_equal(alphaf, model.alphaf.numpy())


@pytest.mark.parametrize("c,s", [(1, 64), (31, 16)])
def test_train_shift_plain_version_is_stage8_chain(c, s):
    """train_shift_fused_ref, the CPU wrapper and train_shift_blend_auto on
    the CPU under every impl equal, bit for bit, the chain that stage 8 ran
    before K6: shift, train from the spectrum, blend."""
    rng = np.random.default_rng(31)
    t = 8
    _, tm, yf = _models(rng, t, c, s)
    tyf = interop.cf_to_complex(yf.re, yf.im)
    zf = torch.fft.rfft2(torch.as_tensor(
        rng.standard_normal((t, c, s, s)).astype(np.float32) * 0.3))
    dy = torch.as_tensor(rng.uniform(-s / 4, s / 4, t).astype(np.float32))
    dx = torch.as_tensor(rng.uniform(-s / 4, s / 4, t).astype(np.float32))
    lr = torch.tensor([0.0, 0.075, 1.0, 0.075] * (t // 4))
    zf_a = t_kcf.shift_spectrum(zf, dy, dx, s)
    chain = t_kcf.blend(tm, t_kcf.train_from_spectrum(zf_a, tyf, 0.2, 1e-4,
                                                      s), lr)
    before = t_fused.launches_train_shift
    got = [t_fused.train_shift_fused_ref(tm, zf, dy, dx, tyf, 0.2, 1e-4, lr,
                                         s),
           t_fused.train_shift_fused(tm, zf, dy, dx, tyf, 0.2, 1e-4, lr, s)]
    got += [t_kcf.train_shift_blend_auto(tm, zf, dy, dx, tyf, 0.2, 1e-4, lr,
                                         s, impl)
            for impl in ("auto", "pallas", "xla")]
    for g in got:
        assert torch.equal(g.xf, chain.xf)
        assert torch.equal(g.alphaf, chain.alphaf)
    assert t_fused.launches_train_shift == before


@pytest.mark.parametrize("device,c,s,width,impl,kernel", [
    ("cuda", 1, 64, 64, "auto", True),
    ("cuda", 1, 64, 64, "pallas", True),
    ("cuda", 1, 64, 64, "xla", False),
    ("cpu", 1, 64, 64, "auto", False),
    ("cpu", 1, 64, 64, "pallas", False),
    ("cuda", 31, 16, 16, "auto", False),     # fHOG-31
    ("cuda", 1, 48, 48, "auto", False),      # bench_template_size
    ("cuda", 1, 32, 32, "pallas", False),
    ("cuda", 3, 64, 64, "auto", False),
])
def test_train_shift_route(device, c, s, width, impl, kernel):
    """K6 for a CUDA spectrum of one channel at S = 64 under "auto" or
    "pallas"; the chain for "xla", the CPU and every other shape."""
    assert t_kcf.train_shift_on_kernel(device, c, s, width, impl) is kernel


# ---- K8: stage 2's search at gray S = 64 (the mirror, the route) ---------
# K8 runs its eight passes on K6's fft64 groups; the mirror repeats them and
# the peak, sub-pixel and PSR rules in numpy float32.  Tolerances: KCF_TOL's
# response limit, relative to the largest magnitude of each tensor, for the
# response, z^, dy, dx, the peak and the PSR; the first maximum's index
# exactly on rows whose top two response values part by more than 1e-5
# relative in the plain version (closer values are a tie that rounding may
# break either way).

K8_RESP = 1e-4


def _search_case(kind, k):
    """(model, feat [k * R, 1, 64, 64]) of one kind: "random", a bank
    trained on seeded features searched on shifted, noisy copies of them
    (a solid peak per row); "shifted", the same with the bank trained as
    stage 8 trains it, on the features' spectra shifted by fractional
    pixels (its x^ is not Hermitian in the DC and Nyquist columns); or
    "bench", the windows of bench.py's objects in its generator's first two
    frames (1080p, 128 objects): the bank trained at frame 0's boxes,
    searched in frame 1 at the same boxes scaled by the 3-scale search's
    1/1.05, 1, 1.05 (k = 3) or 1 (k = 1)."""
    if kind in ("random", "shifted"):
        rng = np.random.default_rng(40 + k)
        feat0 = torch.as_tensor(
            rng.standard_normal((8, 1, 64, 64)).astype(np.float32) * 0.3)
        moved = torch.roll(feat0, shifts=(3, -5), dims=(-2, -1))
        feat = torch.cat([moved + torch.as_tensor(rng.standard_normal(
            moved.shape).astype(np.float32) * 0.05) for _ in range(k)])
    else:
        fx = bench_tool.render(height=1080, width=1920, n_obj=128,
                               n_frames=2, max_tracks=128, max_dets=160)
        cfg = KCFConfig()
        frames = torch.as_tensor(fx.frames)
        boxes = torch.as_tensor(fx.gt_boxes[0])
        scales = (1.0,) if k == 1 else (1 / 1.05, 1.0, 1.05)

        def windows(f, scale):
            wh = torch.tensor([1.0, 1.0, scale, scale])
            return feat_ops.extract_features(roi_k.extract_patches_ref(
                frames[f], boxes * wh, cfg.padding, cfg.template_size), cfg)

        feat0 = windows(0, 1.0)
        feat = torch.cat([windows(1, sc) for sc in scales]).contiguous()
    yf = t_kcf.make_yf(64, 2.5, 0.125)
    zf = torch.fft.rfft2(feat0)
    if kind == "shifted":
        shift = torch.linspace(-7.3, 7.7, feat0.shape[0])
        zf = t_kcf.shift_spectrum(zf, shift, shift.flip(0), 64)
    model = t_kcf.KCFModel(*[x.contiguous() for x in t_kcf.train_from_spectrum(
        zf, yf, 0.2, 1e-4, 64)])
    return model, feat


def _separated(response):
    """Rows whose two largest values part by more than 1e-5 relative."""
    top = response.reshape(response.shape[0], -1).topk(2, dim=1).values
    return (top[:, 0] - top[:, 1]) > 1e-5 * top[:, 0].abs()


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind", ["random", "shifted", "bench"])
def test_search64_mirror_matches_plain_version(kind, k):
    model, feat = _search_case(kind, k)
    want = t_fused.search_fused_ref(model, feat, 0.2)
    got = t_fused.search64_mirror(model.xf.numpy(), model.alphaf.numpy(),
                                  feat.numpy(), 0.2)
    got = t_fused.SearchRows(*got)
    n = feat.shape[0]
    assert got.zf.shape == (n, 1, 64, 33) and got.response.shape == (n, 64,
                                                                     64)
    assert got.idx.dtype == np.int64 and got.psr.dtype == np.float32
    sep = _separated(want.response).numpy()
    assert sep.mean() >= 0.9
    np.testing.assert_array_equal(got.idx[sep], want.idx.numpy()[sep])
    same = got.idx == want.idx.numpy()
    for name in ("zf", "response"):
        assert _max_rel(getattr(got, name),
                        getattr(want, name).numpy()) <= K8_RESP, name
    for name in ("dy", "dx", "peak", "psr"):
        assert _max_rel(getattr(got, name)[same],
                        getattr(want, name).numpy()[same]) <= K8_RESP, name


def test_search_plain_version_is_the_chain():
    """search_fused_ref, the CPU wrapper and ops/kcf.search on the CPU under
    every impl give the chain's values bit for bit: rfft2,
    detect_from_spectrum, peak_displacement, psr; the CPU launches
    nothing, and the chain's Search carries no PSR."""
    model, feat = _search_case("random", 3)
    r = model.xf.shape[0]
    zf = torch.fft.rfft2(feat.reshape(3, r, 1, 64, 64))
    resp = t_kcf.detect_from_spectrum(model, zf, 0.2, 64).reshape(3 * r, 64,
                                                                  64)
    dy, dx, peak, idx = t_kcf.peak_displacement(resp)
    chain = (zf.reshape(3 * r, 1, 64, 33), resp, dy, dx, peak, idx,
             t_kcf.psr(resp, peak, idx))
    before = t_fused.launches_search
    for rows in (t_fused.search_fused_ref(model, feat, 0.2),
                 t_fused.search_fused(model, feat, 0.2)):
        for g, w in zip(rows, chain):
            assert torch.equal(g, w)
    wts = torch.tensor([0.95, 1.0, 0.95])
    for impl in ("auto", "xla", "pallas"):
        found = t_kcf.search(model, feat.reshape(3, r, 1, 64, 64), 0.2, wts,
                             impl)
        assert found.psr is None
        if impl != "pallas":
            assert torch.equal(found.response.reshape(3 * r, 64, 64), resp)
            assert torch.equal(found.idx.reshape(-1), idx)
    with pytest.raises(ValueError, match="multiple"):
        t_fused.search_fused(model, feat[:5], 0.2)
    assert t_fused.launches_search == before


@pytest.mark.parametrize("device,c,s,width,impl,kernel", [
    ("cuda", 1, 64, 64, "auto", True),
    ("cuda", 1, 64, 64, "pallas", False),    # K4
    ("cuda", 1, 64, 64, "xla", False),
    ("cpu", 1, 64, 64, "auto", False),
    ("cpu", 1, 64, 64, "pallas", False),
    ("cuda", 31, 16, 16, "auto", False),     # fHOG-31
    ("cuda", 1, 48, 48, "auto", False),      # bench_template_size
    ("cuda", 1, 32, 32, "auto", False),
    ("cuda", 3, 64, 64, "auto", False),
])
def test_search_route(device, c, s, width, impl, kernel):
    """K8 for CUDA features of one channel at S = 64 under "auto"; K4 for
    "pallas"; the chain for "xla", the CPU and every other shape."""
    assert t_kcf.search_on_kernel(device, c, s, width, impl) is kernel


@pytest.mark.parametrize("k", [1, 3])
def test_unit_psr_reads_the_kernel_psr_or_computes_it(k):
    """ops/kcf.unit_psr: the chain's Search (no PSR) gives psr of the
    unit-scale response (K // 2) bit for bit; a Search that carries a PSR,
    as K8's does, gives that row of it."""
    model, feat = _search_case("random", k)
    r = model.xf.shape[0]
    wts = torch.ones(k) if k == 1 else torch.tensor([0.95, 1.0, 0.95])
    found = t_kcf.search(model, feat.reshape(k, r, 1, 64, 64), 0.2, wts,
                         "auto")
    unit = k // 2
    assert torch.equal(t_kcf.unit_psr(found), t_kcf.psr(
        found.response[unit], found.peaks[unit], found.idx[unit]))
    carried = torch.arange(k * r, dtype=torch.float32).reshape(k, r)
    assert torch.equal(t_kcf.unit_psr(found._replace(psr=carried)),
                       carried[unit])


@pytest.mark.parametrize("fault", [None, "response"])
def test_smoke_holds_each_search_call(monkeypatch, fault):
    """chip_smoke.kernels_checked on the K8 wrapper: each call is filed at
    its shape and held to K8_TOL against the plain version; a call over it
    by its response alone also gets its float64 readings (`k8_f64`: K8's
    and the plain version's response error against the chain in float64),
    which the dist phase's detector cells hold to K8_F64_RATIO.  On the CPU
    the wrapper computes the plain version; a wrapper whose response is
    3e-4 off, its peak, fit and PSR recomputed from it, stands in for a
    faulty kernel."""
    import chip_smoke

    model, feat = _search_case("random", 1)
    fused = t_fused.search_fused
    if fault:
        def off(m, f, sigma):
            rows = fused(m, f, sigma)
            resp = rows.response * (1.0 + 3e-4)
            dy, dx, peak, idx = t_kcf.peak_displacement(resp)
            return t_fused.SearchRows(rows.zf, resp, dy, dx, peak, idx,
                                      t_kcf.psr(resp, peak, idx))
        monkeypatch.setattr(t_fused, "search_fused", off)
    wrapper = t_fused.search_fused
    with chip_smoke.kernels_checked() as st:
        t_fused.search_fused(model, feat, 0.2)
    assert t_fused.search_fused is wrapper
    assert st.calls == {("kcf_search", tuple(feat.shape)): 1}
    (err,) = st.by_kernel()["kcf_search"]
    if fault is None:
        assert err == 0.0 and st.k8_f64 == []
    else:
        assert err == math.inf and len(st.k8_f64) == 1
        k8, plain = st.k8_f64[0]
        assert plain < 1e-5 < 2e-4 < k8
        assert k8 > chip_smoke.K8_F64_RATIO * plain


@pytest.mark.parametrize("pairs,totals,slots,tie", [
    ((40, 40), (16.2802, 16.3224), 11, True),    # 0.042 over 11 slots
    ((40, 40), (16.2802, 16.2802), 2, True),
    ((40, 40), (10.0, 10.06), 2, False),          # over 1.25 eps a slot
    ((40, 39), (16.2802, 16.2802), 2, False),     # another number of pairs
])
def test_smoke_tie_rule(pairs, totals, slots, tie):
    """chip_smoke.is_tie: two matchings from one bank tie when they hold as
    many pairs and their float64-scored totals part by at most
    E2E_TIE_EPS (1.25 auction eps) for each slot they match otherwise."""
    import chip_smoke

    t = dict(frame=0, slots=slots, K8=(pairs[0], totals[0]),
             plain=(pairs[1], totals[1]))
    assert chip_smoke.is_tie(t) is tie


def test_smoke_step_ties_on_the_cpu():
    """chip_smoke.step_ties on a small clip on the CPU, where K8's wrapper
    and its plain version are the same chain: the steps equal run_sequence
    (every output field) and no frame has a choice to witness."""
    import chip_smoke
    from tpu_mot_torch.config import TrackerConfig
    from tpu_mot_torch.data import synthetic
    from tpu_mot_torch.tracker import api, bank as bank_mod, scan

    h, w, n = 96, 128, 4
    objs = synthetic.make_objects(3, h, w, np.random.default_rng(1))
    frames, boxes, vis = synthetic.render_sequence(objs, n, h, w, seed=1)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=h,
                        frame_width=w)
    dets = synthetic.detections_from_gt(boxes, vis, seed=1, frame_hw=(h, w))
    d = np.zeros((n, 8, 5), np.float32)
    v = np.zeros((n, 8), bool)
    for f in range(n):
        d[f], v[f] = api.pad_detections(dets[f], 8)
    frames, d, v = (torch.as_tensor(x) for x in (frames, d, v))
    bank = bank_mod.empty_bank(cfg, device="cpu")
    _, run = scan.run_sequence(bank, frames, d, v, cfg)
    steps, ties = chip_smoke.step_ties(bank, frames, d, v, cfg)
    assert ties == []
    for g, want in zip(steps, run):
        assert torch.equal(g, want)
    assert int(run.valid.sum()) > 0
