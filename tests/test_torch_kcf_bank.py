"""The port's single-object KCF flow (tracker/kcf_bank) and the host
convenience `scan.track_sequence` against the JAX package on the CPU.

A seeded 120 x 160 clip, a bank of T = 3 slots with one dead slot, carried
from JAX into the port through interop at every call.  Tolerances: boxes
1e-2 px and peaks 5e-4 (the responses of the two FFT chains differ by up to
1.6e-4 of their largest value, test_torch_ops.py; the sub-pixel fit divides
such differences by the peak's curvature); model spectra relative to their
largest magnitude, xf 1e-4 and alphaf 1e-3 (JAX's own float64 error, as
test_torch_ops.py holds them).  On the CPU both packages sample patches by
the gather path ("auto" off the accelerator).

The mean IoU of the JAX reference on chip_smoke.py's bank runs (the bench
fixture's 128 first-frame boxes over its 64 frames), which chip_smoke.py
holds the port to on the card, is printed by

    python tests/test_torch_kcf_bank.py bench-ref
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import both_configs
from tpu_mot import config as j_config
from tpu_mot.data import synthetic
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import kcf_bank as j_kb
from tpu_mot.tracker import scan as j_scan
from tpu_mot_torch import config as t_config
from tpu_mot_torch import interop
from tpu_mot_torch.kernels import roi as t_roi
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import kcf_bank as t_kb
from tpu_mot_torch.tracker import scan as t_scan

torch.set_num_threads(1)

H, W = 120, 160
KCF = {
    "gray": dict(template_size=32),
    "gray3": dict(template_size=32, scale_step=1.05),
    "hog": dict(template_size=32, feature_type="hog", cell_size=4),
    "hog3": dict(template_size=32, feature_type="hog", cell_size=4,
                 scale_step=1.05),
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfgs(name):
    return j_config.KCFConfig(**KCF[name]), t_config.KCFConfig(**KCF[name])


def _clip(n=8, seed=4):
    """Three moving objects; slot 2 is dead (its box still rides along)."""
    rng = np.random.default_rng(seed)
    objs = synthetic.make_objects(3, H, W, rng, min_size=14, max_size=26,
                                  max_speed=2.0)
    frames, boxes, _ = synthetic.render_sequence(objs, n, H, W, seed=seed,
                                                 noise=0.01)
    return frames, boxes, np.array([True, True, False])


def _spectral(got, want_cf, rel, what):
    want = np.asarray(want_cf.re) + 1j * np.asarray(want_cf.im)
    assert np.abs(got.numpy() - want).max() <= rel * np.abs(want).max(), what


def _assert_bank(tb, jb, what=""):
    np.testing.assert_allclose(tb.boxes.numpy(), np.asarray(jb.boxes),
                               rtol=0, atol=1e-2, err_msg=what)
    np.testing.assert_array_equal(tb.alive.numpy(), np.asarray(jb.alive))
    _spectral(tb.model.xf, jb.model.xf, 1e-4, f"{what} xf")
    _spectral(tb.model.alphaf, jb.model.alphaf, 1e-3, f"{what} alphaf")


def _init_both(name, frames, boxes, alive):
    jcfg, tcfg = _cfgs(name)
    jb = j_kb.init_bank(jnp.asarray(frames[0]), jnp.asarray(boxes[0]),
                        jnp.asarray(alive), jcfg)
    tb = t_kb.init_bank(_t(frames[0]), _t(boxes[0]), _t(alive), tcfg)
    return jcfg, tcfg, jb, tb


@pytest.mark.parametrize("name", ["gray", "hog"])
def test_init_bank_matches_jax_and_zeroes_dead_slots(name):
    frames, boxes, alive = _clip()
    _, _, jb, tb = _init_both(name, frames, boxes, alive)
    _assert_bank(tb, jb, "init")
    assert tb.model.xf.dtype == torch.complex64
    assert tb.model.xf[2].abs().max() == 0
    assert tb.model.alphaf[2].abs().max() == 0
    assert tb.model.xf[0].abs().max() > 0
    # interop carries the bank both ways without loss
    back = interop.kcf_bank_to_numpy(interop.kcf_bank_from_jax(jb))
    np.testing.assert_array_equal(back["model"]["xf"][0],
                                  np.asarray(jb.model.xf.re))
    np.testing.assert_array_equal(back["model"]["alphaf"][1],
                                  np.asarray(jb.model.alphaf.im))
    np.testing.assert_array_equal(back["boxes"], np.asarray(jb.boxes))
    np.testing.assert_array_equal(back["alive"], np.asarray(jb.alive))


@pytest.mark.parametrize("name", list(KCF))
def test_detect_bank_matches_jax(name):
    frames, boxes, alive = _clip()
    jcfg, tcfg, jb, _ = _init_both(name, frames, boxes, alive)
    tb = interop.kcf_bank_from_jax(jb)
    jbox, jpeak, (jfeat, jdy, jdx) = j_kb.detect_bank(
        jb, jnp.asarray(frames[1]), jcfg, with_aux=True)
    tbox, tpeak, (tfeat, tdy, tdx) = t_kb.detect_bank(
        tb, _t(frames[1]), tcfg, with_aux=True)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(tpeak.numpy(), np.asarray(jpeak), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), rtol=0,
                               atol=1e-5)
    s = tcfg.feature_size
    win = np.asarray(jbox)[:, 2:4] * tcfg.padding / s     # px per template px
    np.testing.assert_allclose(tdx.numpy() * win[:, 0],
                               np.asarray(jdx) * win[:, 0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(tdy.numpy() * win[:, 1],
                               np.asarray(jdy) * win[:, 1], rtol=0, atol=1e-2)
    # The dead slot keeps its box; a live one moved with its object.
    np.testing.assert_array_equal(tbox[2].numpy(), boxes[0, 2])
    assert np.abs(tbox[:2, :2].numpy() - boxes[1, :2, :2]).max() < 2.0
    two = t_kb.detect_bank(tb, _t(frames[1]), tcfg)
    assert len(two) == 2 and torch.equal(two[0], tbox)


def test_train_bank_matches_jax():
    frames, boxes, alive = _clip()
    jcfg, tcfg, jb, _ = _init_both("hog", frames, boxes, alive)
    tb = interop.kcf_bank_from_jax(jb)
    lr = np.array([0.075, 1.0, 0.0], np.float32)
    jb2 = j_kb.train_bank(jb, jnp.asarray(frames[1]), jnp.asarray(boxes[1]),
                          jnp.asarray(lr), jcfg)
    tb2 = t_kb.train_bank(tb, _t(frames[1]), _t(boxes[1]), _t(lr), tcfg)
    _assert_bank(tb2, jb2, "train")
    assert torch.equal(tb2.model.xf[2], tb.model.xf[2])          # lr = 0
    assert not torch.equal(tb2.model.xf[0], tb.model.xf[0])


@pytest.mark.parametrize("train_site", ["refined", "detect"])
@pytest.mark.parametrize("name", ["gray", "hog3"])
def test_step_matches_jax_frame_by_frame(name, train_site):
    frames, boxes, alive = _clip()
    jcfg, tcfg, jb, _ = _init_both(name, frames, boxes, alive)
    for f in range(1, 6):
        tb = interop.kcf_bank_from_jax(jb)
        jb, jpeak = j_kb.step(jb, jnp.asarray(frames[f]), jcfg, train_site)
        tb, tpeak = t_kb.step(tb, _t(frames[f]), tcfg, train_site)
        _assert_bank(tb, jb, f"frame {f}")
        np.testing.assert_allclose(tpeak.numpy(), np.asarray(jpeak), rtol=0,
                                   atol=5e-4, err_msg=f"frame {f}")
    # It tracks (an 8 x 8 fHOG map resolves 10 px of window per cell).
    assert np.abs(tb.boxes[:2, :2].numpy() - boxes[5, :2, :2]).max() < 6.0


def test_detect_site_step_skips_a_slot_that_jumped():
    """The S/4 guard: a slot whose peak lies S/4 or more from the centre
    keeps its model (lr = 0); its box still moves."""
    frames, boxes, alive = _clip()
    _, tcfg, _, tb = _init_both("gray", frames, boxes, alive)
    far = tb.boxes.clone()
    far[0, 0] += 0.3 * tb.boxes[0, 2] * tcfg.padding   # 0.3 of the window
    moved = t_kb.KCFBank(model=tb.model, boxes=far, alive=tb.alive)
    new, _ = t_kb.step(moved, _t(frames[0]), tcfg, "detect")
    assert torch.equal(new.model.xf[0], tb.model.xf[0])
    assert not torch.equal(new.model.xf[1], tb.model.xf[1])
    assert abs(float(new.boxes[0, 0] - tb.boxes[0, 0])) < 1.5    # came back


@pytest.mark.parametrize("train_site", ["refined", "detect"])
def test_run_otb_sequence_matches_jax_and_the_per_frame_steps(train_site):
    frames, boxes, alive = _clip()
    jcfg, tcfg, jb, tb0 = _init_both("gray", frames, boxes, alive)
    _, jboxes, jpeaks = j_kb.run_otb_sequence(jb, jnp.asarray(frames[1:]),
                                              jcfg, train_site)
    tb, tboxes, tpeaks = t_kb.run_otb_sequence(tb0, _t(frames[1:]), tcfg,
                                               train_site)
    assert tboxes.shape == (7, 3, 4) and tpeaks.shape == (7, 3)
    np.testing.assert_allclose(tboxes.numpy(), np.asarray(jboxes), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(tpeaks.numpy(), np.asarray(jpeaks), rtol=0,
                               atol=5e-4)
    step_bank = tb0
    for f in range(1, 8):
        step_bank, peak = t_kb.step(step_bank, _t(frames[f]), tcfg,
                                    train_site)
        assert torch.equal(step_bank.boxes, tboxes[f - 1])
        assert torch.equal(peak, tpeaks[f - 1])
    assert torch.equal(step_bank.model.alphaf, tb.model.alphaf)
    empty = t_kb.run_otb_sequence(tb0, _t(frames[:0]), tcfg, train_site)
    assert empty[1].shape == (0, 3, 4) and empty[2].shape == (0, 3)


def _single_object(n):
    objs = [synthetic.SyntheticObject(cx=160, cy=120, w=28, h=24, vx=2.0,
                                      vy=1.2)]
    return synthetic.render_sequence(objs, n, 240, 320, seed=3, noise=0.0)


def test_kcf_tracker_follows_the_moving_object():
    """tests/test_single_track.py's moving-object case through the port's
    KCFTracker: centre error under 2 px on every frame, and the JAX
    tracker's boxes within 1e-2 px."""
    frames, boxes, _ = _single_object(40)
    tracker = t_kb.KCFTracker(t_config.KCFConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        tracker.update(frames[0])
    tracker.init(frames[0], boxes[0, 0])
    ref = j_kb.KCFTracker(j_config.KCFConfig())
    ref.init(frames[0], boxes[0, 0])
    before = t_roi.launches
    errs = []
    for f in range(1, len(frames)):
        box, peak = tracker.update(frames[f])
        want, want_peak = ref.update(frames[f])
        np.testing.assert_allclose(box, want, rtol=0, atol=1e-2,
                                   err_msg=f"frame {f}")
        assert abs(peak - want_peak) <= 5e-4
        assert box.shape == (4,) and isinstance(peak, float)
        errs.append(np.hypot(box[0] - boxes[f, 0, 0], box[1] - boxes[f, 0, 1]))
    assert max(errs) < 2.0, max(errs)
    assert t_roi.launches == before            # the CPU launches no kernel


def test_run_otb_sequence_equals_the_per_frame_wrapper():
    frames, boxes, _ = _single_object(20)
    cfg = t_config.KCFConfig()
    tracker = t_kb.KCFTracker(cfg, device="cpu")
    tracker.init(frames[0], boxes[0, 0])
    want = [tracker.update(frames[f])[0] for f in range(1, 20)]
    bank = t_kb.init_bank(_t(frames[0]), _t(boxes[0, :1]),
                          torch.ones((1,), dtype=torch.bool), cfg)
    _, got, _ = t_kb.run_otb_sequence(bank, _t(frames[1:]), cfg)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.array(want))


def test_kcf_tracker_defaults_to_the_card():
    """Without a device KCFTracker takes the CUDA card and raises when
    there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        assert t_kb.KCFTracker().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_kb.KCFTracker()


# ---- scan.track_sequence / unpack_outputs ---------------------------------

def _mot_clip(n=10, classes=False, seed=6):
    rng = np.random.default_rng(seed)
    objs = synthetic.make_objects(6, H, W, rng, min_size=12, max_size=24,
                                  max_speed=2.0,
                                  n_classes=3 if classes else 1)
    frames, boxes, vis = synthetic.render_sequence(objs, n, H, W, seed=seed,
                                                   noise=0.01)
    dets = synthetic.detections_from_gt(
        boxes, vis, seed=seed, frame_hw=(H, W),
        classes=[o.cls for o in objs] if classes else None)
    return frames, dets


def _assert_tracks(got, want):
    assert len(got) == len(want)
    for f, (g, w) in enumerate(zip(got, want)):
        assert [t[0] for t in g] == [t[0] for t in w], f"frame {f}"
        if g:
            np.testing.assert_allclose(
                np.array([t[1] for t in g]), np.array([t[1] for t in w]),
                rtol=0, atol=1e-3, err_msg=f"frame {f}")
            np.testing.assert_allclose([t[2] for t in g], [t[2] for t in w],
                                       rtol=0, atol=1e-6)


# chunk 4 over 10 frames leaves a masked tail of 2; 5 divides the clip;
# None is one chunk.
@pytest.mark.parametrize("chunk", [None, 4, 5])
def test_track_sequence_matches_jax(chunk):
    frames, dets = _mot_clip()
    jcfg, tcfg = both_configs(max_tracks=8, max_detections=8, frame_height=H,
                              frame_width=W, roi_impl="xla")
    jb, jtracks, jout = j_scan.track_sequence(frames, dets, jcfg, chunk=chunk)
    tb, ttracks, tout = t_scan.track_sequence(frames, dets, tcfg,
                                              chunk=chunk, device="cpu")
    _assert_tracks(ttracks, jtracks)
    assert any(len(t) >= 5 for t in ttracks)
    for name in ("ids", "valid", "matched_det", "n_births", "assign_iters"):
        got = getattr(tout, name)
        assert isinstance(got, np.ndarray) and got.shape[0] == len(frames)
        np.testing.assert_array_equal(got, np.asarray(getattr(jout, name)),
                                      name)
    assert int(tb.frame_idx) == int(jb.frame_idx) == len(frames)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    _assert_tracks(t_scan.unpack_outputs(tout, len(frames)), ttracks)
    # Tracking goes on from the returned bank as JAX's does.
    jb2, jmore, _ = j_scan.track_sequence(frames[:3], dets[:3], jcfg, bank=jb)
    tb2, tmore, _ = t_scan.track_sequence(frames[:3], dets[:3], tcfg, bank=tb)
    _assert_tracks(tmore, jmore)


def test_track_sequence_promotes_to_six_columns():
    """One 6-column frame widens the whole buffer; the 5-column and empty
    frames of the clip then carry class 0, under the class gate."""
    frames, dets = _mot_clip(classes=True)
    dets = [d.copy() for d in dets]
    dets[2] = dets[2][:, :5]
    dets[4] = np.zeros((0, 5), np.float32)
    dets[6] = dets[6][:, :4]
    jcfg, tcfg = both_configs(max_tracks=8, max_detections=8, frame_height=H,
                              frame_width=W, roi_impl="xla", class_aware=True)
    _, jtracks, jout = j_scan.track_sequence(frames, dets, jcfg, chunk=4)
    _, ttracks, tout = t_scan.track_sequence(frames, dets, tcfg, chunk=4,
                                             device="cpu")
    _assert_tracks(ttracks, jtracks)
    np.testing.assert_array_equal(tout.cls, np.asarray(jout.cls))
    assert len(set(tout.cls[tout.valid].tolist())) > 1


def test_track_sequence_empty_clip_and_unpack_of_tensors():
    jcfg, tcfg = both_configs(max_tracks=8, max_detections=8, frame_height=H,
                              frame_width=W, roi_impl="xla")
    jb, jtracks, jout = j_scan.track_sequence(
        np.zeros((0, H, W), np.float32), [], jcfg)
    tb, ttracks, tout = t_scan.track_sequence(
        np.zeros((0, H, W), np.float32), [], tcfg, device="cpu")
    assert ttracks == jtracks == [] and tout is None and jout is None
    assert int(tb.state.sum()) == int(np.asarray(jb.state).sum()) == 0
    # unpack_outputs also takes run_sequence's stacked tensors
    frames, dets = _mot_clip(4)
    d = np.zeros((4, 8, 5), np.float32)
    v = np.zeros((4, 8), bool)
    from tpu_mot_torch.tracker import api as t_api
    for f in range(4):
        d[f], v[f] = t_api.pad_detections(dets[f], 8)
    _, out = t_scan.run_sequence(t_bank.empty_bank(tcfg, device="cpu"),
                                 _t(frames), _t(d), _t(v), tcfg)
    _, want, _ = t_scan.track_sequence(frames, dets, tcfg, device="cpu")
    assert t_scan.unpack_outputs(out, 4) == want


def test_track_sequence_defaults_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_scan.track_sequence(np.zeros((1, H, W), np.float32),
                              [np.zeros((0, 5), np.float32)])


# ---- the JAX reference on the bench fixture --------------------------------

def bench_ref():
    """Run the JAX bank (tpu_mot on the CPU: the gather path at full
    resolution) as chip_smoke.py's kcf-bank phase runs the port's, and print
    the mean IoU with the ground truth (chip_smoke.KCF_BANK_IOU_REF)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from tpu_mot.ops import patch as j_patch

    frames_u8, _, _, gt_boxes, *_ = chip_smoke.bench_fixture()
    frames = jnp.asarray(frames_u8)
    alive = jnp.ones((gt_boxes.shape[1],), bool)
    for name, (kw, site) in chip_smoke.KCF_BANK.items():
        cfg = j_config.KCFConfig(**kw)
        bank = j_kb.init_bank(j_patch.to_gray(frames[0]),
                              jnp.asarray(gt_boxes[0]), alive, cfg)
        _, boxes, _ = j_kb.run_otb_sequence(bank, frames, cfg, site)
        iou = chip_smoke.box_iou(np.asarray(boxes), gt_boxes)
        print(f"{name}: mean IoU {iou.mean()!r}, last frame "
              f"{iou[-1].mean()!r}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["bench-ref"]:
        bench_ref()
