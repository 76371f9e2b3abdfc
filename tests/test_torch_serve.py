"""The port's multi-stream serving (tpu_mot_torch.parallel.serve and the
stream axis of tracker.step) against the JAX package on the CPU.

  (a) multi_stream_step / multi_stream_sequence against JAX's
      serve.multi_stream_step / multi_stream_sequence on the 4-device CPU
      mesh (the configurations of tests/test_parallel.py, and a u8 fixture
      on the kernel paths), the port stepping from JAX's stacked bank
      carried over by interop: ids and valid exact, boxes within 1e-4;
  (b) the stream step against S single-stream steps, bit for bit: the
      gather path, the kernel path, fHOG-31 + 3 scales with the fused KCF
      kernels, class-aware association with the appearance term, cold and
      warm auction;
  (c) the strided and fused detect -> track serving (the ports of
      tests/test_parallel.py:217-310 and tests/test_appearance_serve.py:
      50-75), against the port's own reference and JAX's outputs;
  (d) the fused KCF kernels' plain versions and their numpy mirror serve
      the [S*T] model rows of S streams (item i reads row i % (S*T));
  (e) the first streams and frames of the serving dump
      (tests/golden/serve_jax_v1.npz: JAX's multi_stream_sequence on
      chip_smoke.py's 8-stream fixture), which chip_smoke.py holds the card
      to at full size.  Regenerate it with

    python tests/test_torch_serve.py regen-serve-dump
"""

import functools
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_config import both_configs
from test_torch_yolo import both_specs, jax_tree
from tpu_mot.models import detector as j_det
from tpu_mot.models import yolo as j_yolo
from tpu_mot.parallel import mesh as mesh_mod
from tpu_mot.parallel import serve as j_serve
from tpu_mot_torch import interop
from tpu_mot_torch.config import KCFConfig, TrackerConfig
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.kernels import auction as t_auction
from tpu_mot_torch.kernels import kcf as t_kcfk
from tpu_mot_torch.models import detector as t_det
from tpu_mot_torch.ops import kcf as t_kcf
from tpu_mot_torch.parallel import serve as t_serve
from tpu_mot_torch.tracker import api as t_api
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import step as t_step
from tpu_mot_torch.utils import metrics as t_metrics

torch.set_num_threads(1)

N_STR = 4


def _np(x):
    return np.asarray(x)


def _jax_banks(jcfg, n):
    return j_serve.make_stream_banks(n, jcfg, mesh_mod.stream_mesh(n))


def _port_banks(jbanks):
    return interop.bank_from_jax(jax.tree.map(np.asarray, jbanks),
                                 device="cpu")


def _leaves(bank):
    """A bank's tensors, the KCF spectra included."""
    return [x for v in bank for x in (v if isinstance(v, t_kcf.KCFModel)
                                      else (v,))]


def _assert_tracks(got, want, what, atol=1e-4):
    np.testing.assert_array_equal(_np(got.ids), _np(want.ids), err_msg=what)
    np.testing.assert_array_equal(_np(got.valid), _np(want.valid),
                                  err_msg=what)
    np.testing.assert_allclose(_np(got.boxes), _np(want.boxes), rtol=0,
                               atol=atol, err_msg=what)


def _streams(n_str, n, h, w, n_obj, cap, width=5, u8=True, seed0=0):
    """n_str synthetic streams (stream s at seed seed0 + s): frames
    [S, N, H, W], detections [S, N, cap, width], valid [S, N, cap]."""
    frames, dets, valid = [], [], []
    for s in range(n_str):
        rng = np.random.default_rng(seed0 + s)
        objs = synthetic.make_objects(n_obj, h, w, rng, max_speed=2.0,
                                      n_classes=3 if width == 6 else 1)
        fr, boxes, vis = synthetic.render_sequence(objs, n, h, w,
                                                   seed=seed0 + s)
        kw = (dict(classes=np.array([o.cls for o in objs]))
              if width == 6 else {})
        dl = synthetic.detections_from_gt(boxes, vis, seed=seed0 + s,
                                          frame_hw=(h, w), **kw)
        d = np.zeros((n, cap, width), np.float32)
        v = np.zeros((n, cap), bool)
        for f in range(n):
            d[f], v[f] = t_api.pad_detections(dl[f], cap, width=width)
        frames.append((fr * 255).astype(np.uint8) if u8
                      else fr.astype(np.float32))
        dets.append(d)
        valid.append(v)
    return np.stack(frames), np.stack(dets), np.stack(valid)


# ---- (a) against JAX's serving on the CPU mesh --------------------------

def _sharded_case():
    """tests/test_parallel.py:27-65: random float frames, two detections a
    stream, 16 slots, the gather path, n_init 1."""
    rng = np.random.default_rng(0)
    frames = rng.random((N_STR, 2, 80, 100)).astype(np.float32)
    dets = np.zeros((N_STR, 2, 8, 5), np.float32)
    valid = np.zeros((N_STR, 2, 8), bool)
    for s in range(N_STR):
        raw = np.concatenate([rng.uniform(20, 80, (2, 2)),
                              rng.uniform(8, 16, (2, 2)),
                              np.ones((2, 1))], 1).astype(np.float32)
        for f in range(2):
            dets[s, f], valid[s, f] = t_api.pad_detections(raw, 8)
    cfgs = both_configs(max_tracks=16, max_detections=8, frame_height=80,
                        frame_width=100, roi_impl="xla", n_init=1)
    return frames, dets, valid, cfgs


def _kernel_case():
    """A u8 fixture on the kernel paths: JAX runs its Pallas kernels in
    interpret mode, the port their plain versions."""
    frames, dets, valid = _streams(N_STR, 3, 120, 160, 5, 8)
    cfgs = both_configs(max_tracks=8, max_detections=8, frame_height=120,
                        frame_width=160, roi_impl="pallas",
                        assign_impl="pallas")
    return frames, dets, valid, cfgs


@pytest.mark.parametrize("case", ["sharded", "kernel paths"])
def test_multi_stream_step_matches_jax(case):
    """Frame 0 from empty banks, then the next frame from JAX's stacked
    bank after frame 0 carried over by interop."""
    frames, dets, valid, (jcfg, tcfg) = (_sharded_case() if case == "sharded"
                                         else _kernel_case())
    jbanks = _jax_banks(jcfg, N_STR)
    tbanks = _port_banks(jbanks)
    assert tbanks.kf_mean.shape == (N_STR, tcfg.max_tracks, 8)
    assert tbanks.next_id.shape == (N_STR,)
    for f in range(2):
        jbanks, jout = j_serve.multi_stream_step(
            jbanks, jnp.asarray(frames[:, f]), jnp.asarray(dets[:, f]),
            jnp.asarray(valid[:, f]), jcfg)
        _, tout = t_serve.multi_stream_step(
            tbanks, torch.as_tensor(frames[:, f]), torch.as_tensor(dets[:, f]),
            torch.as_tensor(valid[:, f]), tcfg)
        _assert_tracks(tout, jout, f"{case} frame {f}")
        assert tout.n_alive.shape == (N_STR,)
        np.testing.assert_array_equal(_np(tout.n_alive), _np(jout.n_alive))
        tbanks = _port_banks(jbanks)
        back = interop.bank_to_numpy(tbanks)        # and back, stacked
        for name in ("kf_mean", "ids", "next_id", "auction_prices"):
            np.testing.assert_array_equal(back[name],
                                          _np(getattr(jbanks, name)))
        np.testing.assert_array_equal(back["kcf"]["xf"][0],
                                      _np(jbanks.kcf.xf.re))
    assert _np(tout.valid).any()


@pytest.mark.parametrize("case", ["no kcf", "kernel paths"])
def test_multi_stream_sequence_matches_jax(case):
    if case == "no kcf":
        # tests/test_parallel.py:68-88: one detection held still, noise.
        frames = np.random.default_rng(1).random(
            (N_STR, 5, 64, 64)).astype(np.float32)
        dets = np.tile(np.asarray([[32, 32, 12, 12, 1.0]], np.float32),
                       (N_STR, 5, 4, 1))
        valid = np.zeros((N_STR, 5, 4), bool)
        valid[:, :, 0] = True
        jcfg, tcfg = both_configs(max_tracks=8, max_detections=4,
                                  frame_height=64, frame_width=64,
                                  roi_impl="xla", n_init=1, use_kcf=False)
    else:
        frames, dets, valid, (jcfg, tcfg) = _kernel_case()
    jbanks, jout = j_serve.multi_stream_sequence(
        _jax_banks(jcfg, N_STR), jnp.asarray(frames), jnp.asarray(dets),
        jnp.asarray(valid), jcfg)
    tbanks, tout = t_serve.multi_stream_sequence(
        t_serve.make_stream_banks(N_STR, tcfg, device="cpu"),
        torch.as_tensor(frames), torch.as_tensor(dets),
        torch.as_tensor(valid), tcfg)
    n = frames.shape[1]
    assert tout.ids.shape == (N_STR, n, tcfg.max_tracks)
    assert tout.n_alive.shape == (N_STR, n)
    _assert_tracks(tout, jout, case)
    np.testing.assert_array_equal(_np(tout.n_alive), _np(jout.n_alive))
    np.testing.assert_array_equal(_np(tbanks.next_id), _np(jbanks.next_id))
    if case == "no kcf":
        assert (tout.n_alive[:, -1] == 1).all()


# ---- (b) the stream step against single-stream steps --------------------

_HEAVY = dict(kcf=KCFConfig(**chip_smoke.HEAVY_KCF))
STEP_MODES = {
    "default gather": dict(),
    "kernel paths": dict(roi_impl="pallas", assign_impl="pallas"),
    "HF": dict(roi_impl="pallas", kcf_impl="pallas", train_site="refined",
               **_HEAVY),
    "H gather": dict(_HEAVY),
    "A": dict(roi_impl="pallas", class_aware=True, appearance_weight=0.3),
    "AW": dict(roi_impl="pallas", class_aware=True, appearance_weight=0.3,
               auction_warm_start=True),
}


@pytest.mark.parametrize("mode", list(STEP_MODES))
def test_stream_step_equals_single_steps(mode):
    """Three streams stepped together equal each stream stepped alone, bit
    for bit, on every field of every frame (the CPU's FFTs, reductions and
    batched products give the same bits for any batch)."""
    width = 6 if mode in ("A", "AW") else 5
    frames, dets, valid = (torch.as_tensor(x) for x in _streams(
        3, 5, 120, 160, 6, 16, width=width))
    cfg = TrackerConfig(max_tracks=8, max_detections=16, frame_height=120,
                        frame_width=160, **STEP_MODES[mode])
    banks = t_serve.make_stream_banks(3, cfg, device="cpu")
    singles = [t_bank.empty_bank(cfg, device="cpu") for _ in range(3)]
    for f in range(frames.shape[1]):
        banks, out = t_serve.multi_stream_step(banks, frames[:, f],
                                               dets[:, f], valid[:, f], cfg)
        for s in range(3):
            singles[s], one = t_step.step(singles[s], frames[s, f],
                                          dets[s, f], valid[s, f], cfg)
            for name in one._fields:
                assert torch.equal(getattr(out, name)[s],
                                   getattr(one, name)), (mode, f, s, name)
            assert all(torch.equal(x[s], y) for x, y in
                       zip(_leaves(banks), _leaves(singles[s])))
    assert out.valid.any()


def test_stream_banks_and_arguments():
    cfg = TrackerConfig(max_tracks=4, max_detections=6, frame_height=32,
                        frame_width=48)
    banks = t_serve.make_stream_banks(3, cfg, device="cpu")
    one = t_bank.empty_bank(cfg, device="cpu")
    for a, b in zip(_leaves(banks), _leaves(one)):
        assert a.shape == (3,) + b.shape and (a == b).all()
    # a stream's fields are its own, not views of one bank
    assert banks.kf_mean.stride(0) == 4 * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_serve.make_stream_banks(2, cfg)
    frames = torch.zeros((5, 3, 32, 48))
    with pytest.raises(ValueError, match="multiple of stride 2"):
        t_serve.multi_stream_sequence_strided(None, banks, frames, cfg,
                                              None, 2)


# ---- (c) detector serving ---------------------------------------------

def _detector_case(num_classes, seed):
    """tests/test_parallel.py:217-310's case: yolov2-tiny at 64, 8 slots,
    96 x 128 float frames, score 0.2, time-major [6, S, H, W].  The 3-class
    net's weights come from seed 3, whose detections above 0.2 hold all
    three classes (seed 0's hold none)."""
    kw = dict(anchors=j_yolo.YOLOV2_TINY_ANCHORS) if num_classes == 1 else {}
    jspec, tspec = both_specs("yolov2-tiny", num_classes=num_classes,
                              input_size=64, **kw)
    tree = interop.numpy_yolo_params(tspec, 0 if num_classes == 1 else 3)
    model = t_det.YoloDetector(tspec, interop.yolo_params_from_jax(tree),
                               device="cpu").model
    frames = np.random.default_rng(seed).random(
        (6, N_STR, 96, 128)).astype(np.float32)

    def t_detect(m, fr):
        return t_det.detect_batch(m, fr, (96, 128), 8, 0.45, 0.2)

    def j_detect(params, fr):
        return j_det.detect_batch(params, fr, jspec, (96, 128), 8, 0.45, 0.2)

    return jax_tree(tree), model, frames, t_detect, j_detect


@pytest.mark.parametrize("class_aware", [False, True])
def test_multistream_strided_equality(class_aware):
    """multi_stream_sequence_strided (stride 3 over 6 frames) equals
    multi_stream_sequence fed detections computed explicitly at the stride
    frames and empty elsewhere (ids, valid and classes exact, boxes within
    0.05 px: the forward over 24 frames and the one over each head frame's
    4 are other batches), and JAX's strided serving on the same weights."""
    jparams, model, frames, t_detect, j_detect = _detector_case(
        3 if class_aware else 1, 7 if class_aware else 5)
    jcfg, tcfg = both_configs(max_tracks=8, max_detections=8,
                              frame_height=96, frame_width=128,
                              roi_impl="xla", class_aware=class_aware)
    n, stride = 6, 3
    ft = torch.as_tensor(frames)
    d, v, c = t_detect(model, ft.reshape(-1, 96, 128))
    if class_aware:
        d = t_det.dets_with_classes(d, c)
    d = d.reshape(n, N_STR, 8, -1)
    v = v.reshape(n, N_STR, 8)
    mask = torch.as_tensor((np.arange(n) % stride) == 0)
    d = d * mask[:, None, None, None]
    v = v & mask[:, None, None]
    banks0 = t_serve.make_stream_banks(N_STR, tcfg, device="cpu")
    _, ref = t_serve.multi_stream_sequence(
        banks0, ft.transpose(0, 1), d.transpose(0, 1), v.transpose(0, 1),
        tcfg)
    _, out = t_serve.multi_stream_sequence_strided(model, banks0, ft, tcfg,
                                                   t_detect, stride)
    assert out.ids.shape == (N_STR, n, 8)
    _assert_tracks(out, ref, "strided vs explicit", atol=0.05)
    np.testing.assert_array_equal(_np(out.cls), _np(ref.cls))
    alive = _np(out.ids) >= 0
    assert alive.any()
    if class_aware:
        assert len(set(_np(out.cls)[alive].tolist())) > 1
    _, jout = j_serve.multi_stream_sequence_strided(
        jparams, _jax_banks(jcfg, N_STR), jnp.asarray(frames), jcfg,
        j_detect, stride)
    _assert_tracks(out, jout, "strided vs JAX", atol=0.05)
    np.testing.assert_array_equal(_np(out.cls), _np(jout.cls))


def test_detect_then_track_step():
    """tests/test_appearance_serve.py:50-75: the fused serving step with a
    random-weight detector over four streams; the shared and the
    data-parallel forms are one forward on one device; against JAX's."""
    jspec, tspec = both_specs("yolov2-tiny", num_classes=1, input_size=64,
                              anchors=j_yolo.YOLOV2_TINY_ANCHORS)
    tree = interop.numpy_yolo_params(tspec, 0)
    model = t_det.YoloDetector(tspec, interop.yolo_params_from_jax(tree),
                               device="cpu").model
    jcfg, tcfg = both_configs(max_tracks=8, max_detections=8,
                              frame_height=64, frame_width=64,
                              roi_impl="xla", n_init=1)
    frames = np.random.default_rng(0).random((N_STR, 64, 64)).astype(
        np.float32)
    t_detect = functools.partial(t_det.detect_batch, frame_hw=(64, 64),
                                 max_out=8, score_thr=0.0)
    banks0 = t_serve.make_stream_banks(N_STR, tcfg, device="cpu")
    ft = torch.as_tensor(frames)
    banks, out = t_serve.detect_then_track_step(model, banks0, ft, tcfg,
                                                t_detect)
    assert torch.isfinite(out.boxes).all()
    assert out.n_alive.shape == (N_STR,) and (out.n_alive > 0).all()
    _, shared = t_serve.detect_then_track_step_shared(model, banks0, ft,
                                                      tcfg, t_detect)
    for name in out._fields:
        assert torch.equal(getattr(out, name), getattr(shared, name))
    d, v = t_serve.shared_detector_detect(model, ft, t_detect,
                                          with_classes=True)
    assert d.shape == (N_STR, 8, 6) and v.shape == (N_STR, 8)
    _, jout = j_serve.detect_then_track_step(
        jax_tree(tree), _jax_banks(jcfg, N_STR), jnp.asarray(frames), jcfg,
        functools.partial(j_det.detect_batch, spec=jspec, frame_hw=(64, 64),
                          max_out=8, score_thr=0.0))
    _assert_tracks(out, jout, "fused step vs JAX", atol=1e-3)


# ---- (d) the fused KCF kernels on [S*T] model rows ---------------------

@pytest.mark.parametrize("c,s", [(31, 16), (1, 64)])
def test_kcf_kernels_serve_stream_rows(c, s):
    """3 streams x 4 tracks as 12 model rows: detect on the 3-scale fold
    [3, 12] (item i reads row i % 12) and train on the 12 rows equal each
    stream run alone, in the plain versions and (S = 16) in the numpy
    mirror of K4's and K5's schedule."""
    rng = np.random.default_rng(c + s)
    n_str, t = 3, 4
    feats = torch.as_tensor(rng.standard_normal(
        (n_str * t, c, s, s)).astype(np.float32) * 0.3)
    yf = t_kcf.make_yf(s, 2.5, 0.1)
    model = t_kcf.train(feats, yf, 0.5, 1e-4)
    f3 = torch.as_tensor(rng.standard_normal(
        (3, n_str * t, c, s, s)).astype(np.float32) * 0.3)
    lr = torch.as_tensor(rng.choice([0.0, 0.075, 1.0], n_str * t).astype(
        np.float32))
    got = t_kcfk.detect_fused(model, f3.reshape((-1, c, s, s)), 0.5)
    got = got.reshape(3, n_str, t, s, s)
    new = t_kcfk.train_fused(model, f3[1], yf, 0.5, 1e-4, lr)
    for st in range(n_str):
        rows = slice(st * t, (st + 1) * t)
        one = t_kcf.KCFModel(*[x[rows] for x in model])
        want = t_kcfk.detect_fused(one, f3[:, rows].reshape((-1, c, s, s)),
                                   0.5).reshape(3, t, s, s)
        assert torch.equal(got[:, st], want)
        new1 = t_kcfk.train_fused(one, f3[1, rows], yf, 0.5, 1e-4, lr[rows])
        assert torch.equal(new.xf[rows], new1.xf)
        assert torch.equal(new.alphaf[rows], new1.alphaf)
    if s == 16:
        xf, af = (x.numpy() for x in model)
        flat = f3.reshape((-1, c, s, s)).numpy()
        mirror = t_kcfk.detect_fft16_mirror(xf, af, flat, 0.5)
        for st in range(n_str):
            rows = slice(st * t, (st + 1) * t)
            one = t_kcfk.detect_fft16_mirror(
                xf[rows], af[rows],
                f3[:, rows].reshape((-1, c, s, s)).numpy(), 0.5)
            np.testing.assert_array_equal(
                mirror.reshape(3, n_str, t, s, s)[:, st],
                one.reshape(3, t, s, s))


def test_checked_run_holds_the_serving_auction_to_its_plain_version():
    """chip_smoke.checked_run, which holds every kernel call of a serving
    run to its plain version on the card: on the CPU the step calls the
    auction wrapper (the plain version there), so the K2 check runs, each
    batch equal to one solve per problem, and the outputs are the
    unchecked run's."""
    frames, dets, valid = (torch.as_tensor(x) for x in _streams(
        3, 4, 120, 160, 5, 8))
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                        frame_width=160, roi_impl="pallas")
    banks = t_serve.make_stream_banks(3, cfg, device="cpu")
    args = (banks, frames, dets, valid, cfg)
    solve = t_auction.auction_solve
    out, errs, rounds, seen = chip_smoke.checked_run(
        t_serve.multi_stream_sequence, *args)
    assert t_auction.auction_solve is solve          # restored
    assert errs == {"auction_solve": [0] * 4}
    assert len(rounds) == 3 * 4 and min(rounds) >= 1
    assert seen["auction_solve"].shape == (3, 8, 8)
    _, plain = t_serve.multi_stream_sequence(*args)
    for name in out._fields:
        assert torch.equal(getattr(out, name), getattr(plain, name))


# ---- (e) the serving dump ---------------------------------------------

def _dump_streams(n_str, n_frames):
    frames, d, v, gt, vis, cfg = chip_smoke.serve_fixture(n_str, n_frames)
    return frames, d, v, gt, vis, cfg.replace(roi_impl="pallas")


def test_serve_dump_first_streams():
    """The port on the CPU (roi_impl="pallas": the pyramid as K1 samples
    it, through K1's plain version) over the first 2 streams x 8 frames of
    the 1080p serving fixture equals the JAX run's dump: ids and valid
    exact, boxes within 1e-3 px."""
    dump = np.load(chip_smoke.SERVE_DUMP)
    assert dump["ids"].shape == (chip_smoke.SERVE_STREAMS,
                                 chip_smoke.SERVE_FRAMES, 128)
    frames, d, v, _, _, cfg = _dump_streams(2, 8)
    _, out = t_serve.multi_stream_sequence(
        t_serve.make_stream_banks(2, cfg, device="cpu"),
        torch.as_tensor(frames), torch.as_tensor(d), torch.as_tensor(v),
        cfg)
    np.testing.assert_array_equal(_np(out.ids), dump["ids"][:2, :8])
    np.testing.assert_array_equal(_np(out.valid), dump["valid"][:2, :8])
    both = _np(out.valid)
    assert both.sum() > 1000
    np.testing.assert_allclose(_np(out.boxes)[both],
                               dump["boxes"][:2, :8][both], rtol=0,
                               atol=1e-3)


def regen_serve_dump():
    """Run the JAX reference (tpu_mot.parallel.serve.multi_stream_sequence
    on the CPU, 8 virtual devices, roi_impl="pallas") over chip_smoke.py's
    serving fixture; write ids, valid, boxes and each stream's MOTA and
    HOTA."""
    jax.config.update("jax_platforms", "cpu")
    frames, d, v, gt, vis, cfg = chip_smoke.serve_fixture()
    n_str, n = frames.shape[:2]
    jcfg, _ = both_configs(max_tracks=cfg.max_tracks,
                           max_detections=cfg.max_detections,
                           frame_height=cfg.frame_height,
                           frame_width=cfg.frame_width, roi_impl="pallas")
    _, o = j_serve.multi_stream_sequence(
        _jax_banks(jcfg, n_str), jnp.asarray(frames), jnp.asarray(d),
        jnp.asarray(v), jcfg)
    out = {"ids": np.asarray(o.ids, np.int32),
           "valid": np.asarray(o.valid, bool),
           "boxes": np.asarray(o.boxes, np.float32)}
    mota, hota = [], []
    for s in range(n_str):
        hyp = [(out["ids"][s, f][out["valid"][s, f]],
                out["boxes"][s, f][out["valid"][s, f]]) for f in range(n)]
        g = [(np.where(vis[s, f])[0], gt[s, f][np.where(vis[s, f])[0]])
             for f in range(n)]
        mota.append(t_metrics.clear_mot(g, hyp)["mota"])
        hota.append(t_metrics.hota(g, hyp)["hota"])
    out["mota"] = np.asarray(mota, np.float64)
    out["hota"] = np.asarray(hota, np.float64)
    print(f"valid slot-frames {int(out['valid'].sum())}; MOTA {mota}; "
          f"HOTA {hota}")
    np.savez_compressed(chip_smoke.SERVE_DUMP, **out)
    print(f"wrote {chip_smoke.SERVE_DUMP}")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen-serve-dump"]:
        regen_serve_dump()
