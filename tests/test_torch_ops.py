"""Leaf-op and KCF parity: tpu_mot_torch.ops against tpu_mot.ops on the CPU.

Inputs are made from a seed with NumPy and handed to both packages.
Tolerances:
  * leaf ops (patch, IoU, Kalman, features): atol/rtol 1e-5 — both sides
    compute in float32 with the same formulas; only summation order and
    fused multiply-adds differ (~1 ulp, values up to ~1e4 for covariances).
  * spectra: 1e-4 relative to the array's largest magnitude — the JAX CPU
    reference computes DFTs as float32 matmuls, the port uses pocketfft;
    both are float32 transforms with different summation orders.
  * alphaf and responses: the spectral divide amplifies those float32
    differences, and the JAX reference is the less accurate of the two
    there; each such test states its bound against JAX and holds the port
    to a float64 oracle as well.
"""

import os
import re
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from tpu_mot.config import KalmanConfig, KCFConfig
from tpu_mot_torch import config as t_config
from tpu_mot.ops import assignment as j_assign
from tpu_mot.ops import features as j_feat
from tpu_mot.ops import fft as j_fft
from tpu_mot.ops import iou as j_iou
from tpu_mot.ops import kalman as j_kalman
from tpu_mot.ops import kcf as j_kcf
from tpu_mot.ops import patch as j_patch
from tpu_mot.ops import window as j_window
from tpu_mot.ops.cfloat import CF
from tpu_mot_torch import interop
from tpu_mot_torch.ops import assignment as t_assign
from tpu_mot_torch.ops import features as t_feat
from tpu_mot_torch.ops import fft as t_fft
from tpu_mot_torch.ops import iou as t_iou
from tpu_mot_torch.ops import kalman as t_kalman
from tpu_mot_torch.ops import kcf as t_kcf
from tpu_mot_torch.ops import patch as t_patch
from tpu_mot_torch.ops import window as t_window

# The tensors here are small: torch's intra-op thread pool would only
# oversubscribe the cores that the JAX side and the other test workers use.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAF = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cf(z: torch.Tensor) -> np.ndarray:
    return z.numpy()


def _jc(cf: CF) -> np.ndarray:
    return np.asarray(cf.re) + 1j * np.asarray(cf.im)


def _assert_spectral(got, want, rel=1e-4):
    """`rel` relative to the largest magnitude (see module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _boxes(rng, t, h, w):
    b = np.stack([rng.uniform(0, w, t), rng.uniform(0, h, t),
                  rng.uniform(4, 60, t), rng.uniform(4, 60, t)], 1)
    b[0] = [0.0, 0.0, 10.0, 12.0]          # corner
    b[1] = [w - 1.0, h - 1.0, 20.0, 8.0]   # opposite corner
    b[2] = [w / 2, h / 2, 0.0, -3.0]       # degenerate
    return b.astype(np.float32)


def test_window_constants_identical():
    for h, w in [(64, 64), (16, 24)]:
        np.testing.assert_array_equal(t_window.hann2d(h, w).numpy(),
                                      j_window.hann2d(h, w))
        sigma = t_window.output_sigma(h, w, 2.5, 0.125)
        assert sigma == j_window.output_sigma(h, w, 2.5, 0.125)
        np.testing.assert_array_equal(
            t_window.gaussian_peak(h, w, sigma).numpy(),
            j_window.gaussian_peak(h, w, sigma))
    with pytest.raises(ValueError):
        t_window.hann2d(1, 8)


def test_gray_features_match_and_hog_raises():
    """Gray features match JAX's; fHOG, which raised before the heavy path
    was ported, now matches too (tests/test_torch_hog.py covers it)."""
    rng = np.random.default_rng(0)
    p = rng.random((3, 64, 64)).astype(np.float32)
    for kw in (dict(), dict(feature_type="hog", cell_size=4)):
        np.testing.assert_allclose(
            t_feat.extract_features(_t(p), t_config.KCFConfig(**kw)).numpy(),
            np.asarray(j_feat.extract_features(jnp.asarray(p),
                                               KCFConfig(**kw))), **LEAF)


@pytest.mark.parametrize("shape,dtype", [((24, 32), np.uint8),
                                         ((24, 32, 3), np.uint8),
                                         ((24, 32, 3), np.float32),
                                         ((24, 32, 1), np.float32)])
def test_to_gray(shape, dtype):
    rng = np.random.default_rng(1)
    f = (rng.integers(0, 256, shape).astype(dtype) if dtype == np.uint8
         else rng.random(shape).astype(dtype))
    np.testing.assert_allclose(t_patch.to_gray(_t(f)).numpy(),
                               np.asarray(j_patch.to_gray(jnp.asarray(f))),
                               **LEAF)


def test_gather_extract_patches():
    rng = np.random.default_rng(2)
    h, w = 61, 83                                  # odd extents
    frame = rng.random((h, w)).astype(np.float32)
    boxes = _boxes(rng, 9, h, w)
    want = np.asarray(j_patch.extract_patches(jnp.asarray(frame),
                                              jnp.asarray(boxes), 2.5, 16))
    got = t_patch.extract_patches(_t(frame), _t(boxes), 2.5, 16).numpy()
    np.testing.assert_allclose(got, want, **LEAF)
    ys = rng.uniform(-5, h + 5, (4, 7)).astype(np.float32)
    xs = rng.uniform(-5, w + 5, (4, 7)).astype(np.float32)
    np.testing.assert_allclose(
        t_patch.bilinear_sample(_t(frame), _t(ys), _t(xs)).numpy(),
        np.asarray(j_patch.bilinear_sample(jnp.asarray(frame),
                                           jnp.asarray(ys), jnp.asarray(xs))),
        **LEAF)


def test_extract_patches_auto_dispatch_on_cpu():
    """On the CPU "auto" and "xla" take the gather path; "pallas" takes the
    pyramid path through the ROI wrapper's plain version."""
    from tpu_mot_torch.kernels import roi

    rng = np.random.default_rng(3)
    frame = _t(rng.random((48, 64)).astype(np.float32))
    boxes = _t(np.array([[20.0, 20.0, 10.0, 12.0]], np.float32))
    gather = t_patch.extract_patches(frame, boxes, 2.5, 16)
    for impl in ("auto", "xla"):
        assert torch.equal(t_patch.extract_patches_auto(
            frame, boxes, 2.5, 16, impl=impl), gather)
    assert torch.equal(
        t_patch.extract_patches_auto(frame, boxes, 2.5, 16, impl="pallas"),
        roi.extract_patches_ref(frame, boxes, 2.5, 16))


def test_iou_and_association_cost():
    rng = np.random.default_rng(4)
    a = _boxes(rng, 7, 100, 120)
    b = _boxes(rng, 5, 100, 120)
    b[:3] = a[3:6] + rng.normal(0, 2, (3, 4)).astype(np.float32)
    tv = np.array([1, 1, 0, 1, 1, 1, 1], bool)
    dv = np.array([1, 1, 1, 0, 1], bool)
    np.testing.assert_allclose(
        t_iou.pairwise_iou(_t(a), _t(b)).numpy(),
        np.asarray(j_iou.pairwise_iou(jnp.asarray(a), jnp.asarray(b))),
        **LEAF)
    got = t_iou.association_cost(_t(a), _t(b), _t(tv), _t(dv), 0.3,
                                 1e4).numpy()
    want = np.asarray(j_iou.association_cost(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(tv), jnp.asarray(dv),
        0.3, 1e4))
    np.testing.assert_allclose(got, want, **LEAF)
    assert (got < 1e3).sum() >= 2              # the gate passes real pairs


def test_kalman_init_predict_correct():
    rng = np.random.default_rng(5)
    cfg = KalmanConfig()
    tcfg = t_config.KalmanConfig()
    boxes = _boxes(rng, 6, 1080, 1920)
    tm, tc = t_kalman.init(_t(boxes), tcfg)
    jm, jc = j_kalman.init(jnp.asarray(boxes), cfg)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **LEAF)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **LEAF)
    for _ in range(2):
        tm, tc = t_kalman.predict(tm, tc, tcfg)
        jm, jc = j_kalman.predict(jm, jc, cfg)
        z = (np.asarray(jm)[:, :4]
             + rng.normal(0, 2, (6, 4))).astype(np.float32)
        gate = np.array([1, 0, 1, 1, 0, 1], bool)
        tm, tc = t_kalman.correct(tm, tc, _t(z), _t(gate), tcfg)
        jm, jc = j_kalman.correct(jm, jc, jnp.asarray(z), jnp.asarray(gate),
                                  cfg)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **LEAF)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **LEAF)


def test_inv4x4_spd_matches_jax_and_inverse():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((5, 4, 4)).astype(np.float32)
    s = (a @ a.transpose(0, 2, 1) + 4 * np.eye(4)).astype(np.float32)
    got = t_kalman._inv4x4_spd(_t(s)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_kalman._inv4x4_spd(jnp.asarray(s))), **LEAF)
    np.testing.assert_allclose(got @ s, np.broadcast_to(np.eye(4), s.shape),
                               atol=1e-4)


def test_fft_matches_jax_dft():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1, 64, 64)).astype(np.float32)
    xf = t_fft.rfft2(_t(x))
    assert xf.dtype == torch.complex64 and xf.shape[-1] == 33
    _assert_spectral(_cf(xf), _jc(j_fft.rfft2(jnp.asarray(x))))
    np.testing.assert_allclose(t_fft.irfft2(xf, 64).numpy(), x, atol=1e-5)
    np.testing.assert_array_equal(t_fft._hermitian_weights(64).numpy(),
                                  j_fft._hermitian_weights(64))
    np.testing.assert_array_equal(t_fft._hermitian_weights(7).numpy(),
                                  j_fft._hermitian_weights(7))


def _kcf_inputs(seed, t=3):
    rng = np.random.default_rng(seed)
    p = rng.random((t, 64, 64)).astype(np.float32)
    z = rng.random((t, 64, 64)).astype(np.float32)
    cfg = KCFConfig()
    xj = j_feat.extract_features(jnp.asarray(p), cfg)
    zj = j_feat.extract_features(jnp.asarray(z), cfg)
    tcfg = t_config.KCFConfig()
    return (j_fft.rfft2(xj), j_fft.rfft2(zj),
            t_fft.rfft2(t_feat.extract_features(_t(p), tcfg)),
            t_fft.rfft2(t_feat.extract_features(_t(z), tcfg)))


def test_kcf_train_detect_chain_matches_jax():
    xfj, zfj, xft, zft = _kcf_inputs(8)
    np.testing.assert_allclose(t_kcf._parseval_energy(xft, 64).numpy(),
                               np.asarray(j_kcf._parseval_energy(xfj, 64)),
                               rtol=1e-5)
    _assert_spectral(_cf(t_kcf.gaussian_correlation(xft, zft, 0.2, 64)),
                     _jc(j_kcf.gaussian_correlation(xfj, zfj, 0.2, 64)))
    yfj = j_kcf.make_yf(64, 2.5, 0.125)
    yft = t_kcf.make_yf(64, 2.5, 0.125)
    _assert_spectral(_cf(yft), _jc(yfj))
    mj = j_kcf.train_from_spectrum(xfj, yfj, 0.2, 1e-4, 64)
    mt = t_kcf.train_from_spectrum(xft, yft, 0.2, 1e-4, 64)
    _assert_spectral(_cf(mt.xf), _jc(mj.xf))
    # alphaf = yf / (kf + 1e-4) amplifies the float32 error of kf where kf
    # is small: the JAX reference itself sits up to 4.7e-4 (relative to the
    # largest |alphaf|) from the float64 oracle on these inputs, the port
    # up to 1.0e-4, so the two agree to 1e-3; test_alphaf_vs_float64_oracle
    # holds the port to the oracle.
    want = _jc(mj.alphaf)
    assert (np.abs(_cf(mt.alphaf) - want).max()
            <= 1e-3 * np.abs(want).max())
    # The response, from one and the same model (carried over by interop).
    mt_j = t_kcf.KCFModel(
        xf=interop.cf_to_complex(mj.xf.re, mj.xf.im),
        alphaf=interop.cf_to_complex(mj.alphaf.re, mj.alphaf.im))
    rj = np.asarray(j_kcf.detect_from_spectrum(mj, zfj, 0.2, 64))
    rt = t_kcf.detect_from_spectrum(mt_j, zft, 0.2, 64).numpy()
    # The response sums products of |alphaf| up to ~350 into values below
    # 0.25: against float64 the JAX reference is off by up to 1.6e-4 of
    # the largest |response|, the port by up to 3.9e-5.  So: 5e-4 against
    # JAX, 1e-4 against float64.
    _assert_spectral(rt, rj, rel=5e-4)
    zfeat = t_fft.irfft2(zft, 64).numpy().astype(np.float64)
    xfeat = t_fft.irfft2(mt_j.xf, 64).numpy().astype(np.float64)
    for t in range(rt.shape[0]):
        k = oracles.gaussian_correlation(zfeat[t], xfeat[t], 0.2)
        r64 = np.fft.irfft2(np.fft.rfft2(k) * mt_j.alphaf[t].numpy(),
                            s=(64, 64))
        _assert_spectral(rt[t], r64)
    # div_real_shifted with a denominator at the 1e-20 floor.
    k = np.zeros((2, 3), np.complex64)
    k[0, 0] = -1e-4
    y = np.ones((2, 3), np.complex64)
    got = t_kcf.div_real_shifted(torch.as_tensor(y), torch.as_tensor(k),
                                 1e-4).numpy()
    want = _jc(j_kcf.cfloat.div_real_shifted(
        CF(jnp.asarray(y.real), jnp.asarray(y.imag)),
        CF(jnp.asarray(k.real), jnp.asarray(k.imag)), 1e-4))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_alphaf_vs_float64_oracle():
    """Float32 grade against the float64 KCF oracle: relative to the
    largest |alphaf|, 3e-4 (measured up to 1.0e-4: the float32 Parseval
    energies cancel against the cross term near zero shift and the
    spectral divide amplifies that; the JAX reference measures up to
    4.7e-4 on the same kind of input)."""
    rng = np.random.default_rng(9)
    p = rng.random((2, 64, 64)).astype(np.float32)
    feat = t_feat.extract_features(_t(p), t_config.KCFConfig())
    model = t_kcf.train_from_spectrum(t_fft.rfft2(feat),
                                      t_kcf.make_yf(64, 2.5, 0.125),
                                      0.2, 1e-4, 64)
    oracle = oracles.KCFOracle()
    for t in range(2):
        x = feat[t].numpy().astype(np.float64)
        k = oracles.gaussian_correlation(x, x, 0.2)
        want = (oracle.yf / (np.fft.fft2(k) + 1e-4))[:, :33]
        got = model.alphaf[t].numpy()
        assert np.abs(got - want).max() <= 3e-4 * np.abs(want).max()


def test_shift_spectrum_and_blend():
    xfj, _, xft, _ = _kcf_inputs(10)
    rng = np.random.default_rng(10)
    dy = rng.uniform(-6, 6, 3).astype(np.float32)
    dx = rng.uniform(-6, 6, 3).astype(np.float32)
    sj = j_kcf.shift_spectrum(xfj, jnp.asarray(dy), jnp.asarray(dx), 64)
    st = t_kcf.shift_spectrum(xft, _t(dy), _t(dx), 64)
    _assert_spectral(_cf(st), _jc(sj))
    yfj = j_kcf.make_yf(64, 2.5, 0.125)
    mj = j_kcf.train_from_spectrum(xfj, yfj, 0.2, 1e-4, 64)
    nj = j_kcf.train_from_spectrum(sj, yfj, 0.2, 1e-4, 64)

    def port(m):
        return t_kcf.KCFModel(
            xf=interop.cf_to_complex(m.xf.re, m.xf.im),
            alphaf=interop.cf_to_complex(m.alphaf.re, m.alphaf.im))

    mt, nt = port(mj), port(nj)
    lr = np.array([0.0, 0.075, 1.0], np.float32)
    bj = j_kcf.blend(mj, nj, jnp.asarray(lr))
    bt = t_kcf.blend(mt, nt, _t(lr))
    np.testing.assert_allclose(_cf(bt.xf), _jc(bj.xf), **LEAF)
    np.testing.assert_allclose(_cf(bt.alphaf), _jc(bj.alphaf), **LEAF)
    assert torch.equal(bt.xf[0], mt.xf[0]) and torch.equal(bt.xf[2],
                                                           nt.xf[2])


def test_peak_displacement_and_psr():
    rng = np.random.default_rng(11)
    r = rng.random((6, 64, 64)).astype(np.float32)
    r[0, 10, 20] = 5.0                                   # interior peak
    r[1, 0, 0] = 5.0                                     # corner peak
    r[2, 63, 5] = 5.0                                    # edge peak
    r[3, 30, 30] = r[3, 30, 31] = 5.0                    # tie: first wins
    r[4, 31, 33], r[4, 31, 32], r[4, 31, 34] = 4.0, 3.9, 1.0
    got = [x.numpy() for x in t_kcf.peak_displacement(_t(r))]
    want = [np.asarray(x) for x in j_kcf.peak_displacement(jnp.asarray(r))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **LEAF)
    # the peak's flat index: the first maximum (row 3's tie), as psr takes it
    np.testing.assert_array_equal(got[3], r.reshape(6, -1).argmax(axis=1))
    assert got[3][3] == 30 * 64 + 30
    np.testing.assert_allclose(
        t_kcf.psr(_t(r), _t(want[2]), _t(got[3])).numpy(),
        np.asarray(j_kcf.psr(jnp.asarray(r), jnp.asarray(want[2]))),
        **LEAF)


def test_build_benefits_and_strip_to_rows_exact():
    rng = np.random.default_rng(12)
    for n, m in [(6, 9), (9, 6)]:
        cost = rng.uniform(0, 2, (n, m)).astype(np.float32)
        feas = rng.random((n, m)) < 0.5
        feas[0] = False                                  # a dead row
        bj = np.asarray(j_assign.build_benefits(jnp.asarray(cost),
                                                jnp.asarray(feas), 0.02))
        bt = t_assign.build_benefits(_t(cost), _t(feas), 0.02).numpy()
        np.testing.assert_array_equal(bt, bj)
        col = rng.integers(-1, max(n, m), max(n, m)).astype(np.int32)
        np.testing.assert_array_equal(
            t_assign.strip_to_rows(_t(col), _t(feas), n, m).numpy(),
            np.asarray(j_assign.strip_to_rows(jnp.asarray(col),
                                              jnp.asarray(feas), n, m)))
        np.testing.assert_array_equal(t_assign.scipy_assign(cost, feas),
                                      j_assign.scipy_assign(cost, feas))


def test_interop_cf_roundtrip():
    rng = np.random.default_rng(13)
    re = rng.standard_normal((2, 3)).astype(np.float32)
    im = rng.standard_normal((2, 3)).astype(np.float32)
    z = interop.cf_to_complex(re, im)
    assert z.dtype == torch.complex64
    r2, i2 = interop.complex_to_cf(z)
    np.testing.assert_array_equal(r2, re)
    np.testing.assert_array_equal(i2, im)


def test_port_imports_without_jax():
    """Every tpu_mot_torch module and chip_smoke.py load in a process where
    importing jax, flax, optax, orbax or anything of the JAX package
    (tpu_mot) fails; no port module names jax or tpu_mot."""
    pkg = os.path.join(_REPO, "tpu_mot_torch")
    mods = []
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]     # build outputs
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    src = fh.read()
                assert "import jax" not in src and "from jax" not in src, path
                assert not re.search(r"(from|import) tpu_mot[ .]", src), path
                rel = os.path.relpath(path, _REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[:-len(".__init__")]
                            if rel.endswith(".__init__") else rel)
    assert {"tpu_mot_torch.tracker.kcf_bank", "tpu_mot_torch.tracker.scan",
            "tpu_mot_torch.ops.assignment", "tpu_mot_torch.interop",
            "tpu_mot_torch.models.yolo", "tpu_mot_torch.models.detector",
            "tpu_mot_torch.ops.nms", "tpu_mot_torch.parallel.serve",
            "tpu_mot_torch.utils.supervisor",
            "tpu_mot_torch.utils.profiling", "tpu_mot_torch.parallel.train",
            "tpu_mot_torch.utils.checkpoint", "tpu_mot_torch.native",
            "tpu_mot_torch.data.mot", "tpu_mot_torch.data.video",
            "tpu_mot_torch.utils.viz", "tpu_mot_torch.cli",
            "tpu_mot_torch.parallel.mesh", "tpu_mot_torch.parallel.dryrun",
            "tpu_mot_torch.__main__", "tpu_mot_torch.tools.bench",
            "tpu_mot_torch.tools.bench_e2e",
            "tpu_mot_torch.tools.bench_variants",
            "tpu_mot_torch.tools.bench_latency",
            "tpu_mot_torch.tools.bench_otb",
            "tpu_mot_torch.tools.bench_configs4",
            "tpu_mot_torch.tools.bench_ingest",
            "tpu_mot_torch.tools.bench_hard_fixture",
            "tpu_mot_torch.tools.bench_multistream",
            "tpu_mot_torch.tools.bench_class_cost",
            "tpu_mot_torch.tools.bench_train_site",
            "tpu_mot_torch.tools.bench_template_size",
            "tpu_mot_torch.tools.train_e2e_mota"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        sys.modules["optax"] = None
        sys.modules["orbax"] = None
        sys.modules["tpu_mot"] = None
        for m in {sorted(mods)!r} + ["chip_smoke"]:
            importlib.import_module(m)
        scan = sys.modules["tpu_mot_torch.tracker.scan"]
        assert callable(scan.run_sequence_strided_detector)
        assert callable(scan.run_sequence_strided_batched)
        assert not any(k.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                           "tpu_mot")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
