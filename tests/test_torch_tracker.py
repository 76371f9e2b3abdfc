"""The port's tracker slice against the JAX tracker on the CPU.

  (a) the port reproduces tests/golden/mot_synthetic_v1.npz on
      test_golden.py's fixture with its tolerances (ids and valid exact,
      boxes atol 1e-3);
  (b) one step from a mid-sequence JAX bank, carried over by interop,
      matches JAX's step: ids, lifecycle and matches exact, boxes atol
      1e-3 (as the golden), spectra 1e-3 relative to their largest
      magnitude (alphaf is a spectral divide; test_torch_ops bounds it);
  (c) on a small u8 fixture the kernel paths (roi_impl="pallas",
      assign_impl="pallas") of both packages agree, JAX running its Pallas
      kernels in interpret mode and the port the kernels' plain versions:
      ids and valid exact, boxes atol 1e-3;
  (d) MultiTracker init/update and the save/load round trip.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_golden import GOLDEN, _check
from test_torch_config import both_configs
from tpu_mot.data import synthetic
from tpu_mot.ops.cfloat import CF
from tpu_mot.ops.kcf import KCFModel as JKCFModel
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import scan as j_scan
from tpu_mot.tracker import step as j_step
from tpu_mot.tracker.api import pad_detections as j_pad
from tpu_mot_torch import config as t_config
from tpu_mot_torch import interop
from tpu_mot_torch.kernels import auction as t_auction
from tpu_mot_torch.kernels import roi as t_roi
from tpu_mot_torch.tracker import api as t_api
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import scan as t_scan
from tpu_mot_torch.tracker import step as t_step

# The tensors here are small: torch's intra-op thread pool would only
# oversubscribe the cores that the JAX side and the other test workers use.
torch.set_num_threads(1)


def _fixture(seed, n_obj, n_frames, h, w, **kw):
    rng = np.random.default_rng(seed)
    objs = synthetic.make_objects(n_obj, h, w, rng, **kw)
    frames, boxes, vis = synthetic.render_sequence(objs, n_frames, h, w,
                                                   seed=seed)
    dets = synthetic.detections_from_gt(boxes, vis, seed=seed,
                                        frame_hw=(h, w))
    return frames, dets


def _padded(dets, cap):
    d = np.zeros((len(dets), cap, 5), np.float32)
    v = np.zeros((len(dets), cap), bool)
    for f, df in enumerate(dets):
        d[f], v[f] = t_api.pad_detections(df, cap)
    return d, v


def _golden_inputs():
    """test_golden.py's fixture and config: (frames, dets, JAX config, the
    port's config)."""
    frames, dets = _fixture(42, 10, 25, 240, 320, max_speed=2.5)
    jcfg, tcfg = both_configs(max_tracks=32, max_detections=16,
                              frame_height=240, frame_width=320,
                              roi_impl="xla")
    return frames, dets, jcfg, tcfg


def _run_port(frames, dets, cfg):
    d, v = _padded(dets, cfg.max_detections)
    return t_scan.run_sequence(
        t_bank.empty_bank(cfg, device="cpu"), torch.as_tensor(frames),
        torch.as_tensor(d), torch.as_tensor(v), cfg)


def _np_out(out):
    return types.SimpleNamespace(ids=out.ids.numpy(),
                                 valid=out.valid.numpy(),
                                 boxes=out.boxes.numpy())


def test_golden_mot_dump():
    frames, dets, _, cfg = _golden_inputs()
    _, out = _run_port(frames, dets, cfg)
    assert out.valid.numpy().any()
    _check(_np_out(out), GOLDEN)


def _jax_bank(fields):
    kcf = fields.pop("kcf")
    return j_bank.TrackBank(
        kcf=JKCFModel(xf=CF(*map(jnp.asarray, kcf["xf"])),
                      alphaf=CF(*map(jnp.asarray, kcf["alphaf"]))),
        **{k: jnp.asarray(v) for k, v in fields.items()})


def _assert_spectral(got, want, rel):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale


def test_step_from_mid_sequence_jax_bank():
    frames, dets, jcfg, cfg = _golden_inputs()
    d, v = _padded(dets, cfg.max_detections)
    k = 12
    jb = j_bank.empty_bank(jcfg)
    for f in range(k):         # the jitted step, compiled once for all k + 1
        jb, _ = j_step.step(jb, jnp.asarray(frames[f]), jnp.asarray(d[f]),
                            jnp.asarray(v[f]), jcfg)
    tb = interop.bank_from_jax(jb)
    # interop round trip is lossless in both directions
    back = _jax_bank(interop.bank_to_numpy(tb))
    for a, b in zip(jax_leaves(back), jax_leaves(jb)):
        np.testing.assert_array_equal(a, b)
    jb2, jo = j_step.step(jb, jnp.asarray(frames[k]), jnp.asarray(d[k]),
                          jnp.asarray(v[k]), jcfg)
    tb2, to = t_step.step(tb, torch.as_tensor(frames[k]),
                          torch.as_tensor(d[k]), torch.as_tensor(v[k]), cfg)
    for name in ("ids", "valid", "matched_det", "cls", "n_alive",
                 "n_births", "n_deaths", "n_matches", "assign_iters",
                 "assign_converged"):
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)), name)
    np.testing.assert_allclose(to.boxes.numpy(), np.asarray(jo.boxes),
                               rtol=0, atol=1e-3)
    got = interop.bank_to_numpy(tb2)
    for name in ("ids", "state", "hits", "time_since_update", "age", "cls",
                 "next_id", "frame_idx"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jb2,
                                                                    name)))
    np.testing.assert_allclose(got["kf_mean"], np.asarray(jb2.kf_mean),
                               rtol=1e-5, atol=1e-3)
    for part in ("xf", "alphaf"):
        cf = getattr(jb2.kcf, part)
        _assert_spectral(got["kcf"][part][0] + 1j * got["kcf"][part][1],
                         np.asarray(cf.re) + 1j * np.asarray(cf.im), 1e-3)


def jax_leaves(bank):
    return [np.asarray(x) for x in (
        bank.kf_mean, bank.kf_cov, bank.kcf.xf.re, bank.kcf.xf.im,
        bank.kcf.alphaf.re, bank.kcf.alphaf.im, bank.ids, bank.state,
        bank.hits, bank.time_since_update, bank.age, bank.score, bank.cls,
        bank.auction_prices, bank.auction_col_of, bank.next_id,
        bank.frame_idx)]


def test_kernel_paths_match_jax_interpret_on_u8_fixture():
    h, w = 240, 320
    frames, dets = _fixture(5, 8, 8, h, w, max_speed=2.0)
    frames_u8 = (frames * 255).astype(np.uint8)
    jcfg, cfg = both_configs(max_tracks=32, max_detections=16,
                             frame_height=h, frame_width=w, roi_impl="pallas",
                             assign_impl="pallas")
    d, v = _padded(dets, cfg.max_detections)
    _, jo = j_scan.run_sequence(j_bank.empty_bank(jcfg),
                                jnp.asarray(frames_u8), jnp.asarray(d),
                                jnp.asarray(v), jcfg)
    roi_before, auc_before = t_roi.launches, t_auction.launches
    _, to = t_scan.run_sequence(t_bank.empty_bank(cfg, device="cpu"),
                                torch.as_tensor(frames_u8),
                                torch.as_tensor(d), torch.as_tensor(v), cfg)
    assert (t_roi.launches, t_auction.launches) == (roi_before, auc_before)
    assert to.valid.numpy().any()
    np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_allclose(to.boxes.numpy(), np.asarray(jo.boxes),
                               rtol=0, atol=1e-3)


def test_frame_valid_masking_and_class_column():
    """frame_valid=False frames are no-ops; a 6th detection column becomes
    StepOutput.cls (as in JAX)."""
    frames, dets, jcfg, cfg = _golden_inputs()
    n = 6
    d, v = _padded(dets[:n], cfg.max_detections)
    d6 = np.concatenate([d, np.full(d.shape[:2] + (1,), 3.0, np.float32)],
                        axis=2)
    fv = np.array([1, 1, 0, 1, 0, 1], bool)
    jb, jo = j_scan.run_sequence(j_bank.empty_bank(jcfg),
                                 jnp.asarray(frames[:n]), jnp.asarray(d6),
                                 jnp.asarray(v), jcfg,
                                 frame_valid=jnp.asarray(fv))
    tb, to = t_scan.run_sequence(t_bank.empty_bank(cfg, device="cpu"),
                                 torch.as_tensor(frames[:n]),
                                 torch.as_tensor(d6), torch.as_tensor(v),
                                 cfg, frame_valid=torch.as_tensor(fv))
    for name in ("ids", "valid", "cls", "n_births"):
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)), name)
    np.testing.assert_allclose(to.boxes.numpy(), np.asarray(jo.boxes),
                               rtol=0, atol=1e-3)
    assert int(tb.frame_idx) == int(jb.frame_idx) == fv.sum()
    assert set(to.cls.numpy()[to.valid.numpy()].tolist()) == {3}


def test_multitracker_matches_run_sequence_and_save_load():
    frames, dets, _, cfg = _golden_inputs()
    _, seq = _run_port(frames[:8], dets[:8], cfg)
    mt = t_api.MultiTracker(cfg, device="cpu")
    got = [mt.init(frames[0], dets[0])]
    for f in range(1, 5):
        got.append(mt.update(frames[f], dets[f]))
    for f, tracks in enumerate(got):
        sel = np.where(seq.valid[f].numpy())[0]
        assert [t[0] for t in tracks] == seq.ids[f, sel].tolist()
        np.testing.assert_array_equal(
            np.array([t[1] for t in tracks], np.float32).reshape(-1, 4),
            seq.boxes[f, sel].numpy())
    assert mt.counters()["alive"] > 0
    snap = mt.save_state()
    after = [mt.update(frames[f], dets[f]) for f in (5, 6)]
    mt2 = t_api.MultiTracker(cfg, device="cpu")
    mt2.load_state(snap)
    assert [mt2.update(frames[f], dets[f]) for f in (5, 6)] == after
    # Snapshots are host copies: the live bank moved on, the snapshot did not.
    assert int(snap["bank"].frame_idx) == 5 and int(mt.bank.frame_idx) == 7
    with pytest.raises(RuntimeError):
        t_api.MultiTracker(cfg, device="cpu").update(frames[0], dets[0])
    assert t_api.reset(cfg, device="cpu").state.sum() == 0
    np.testing.assert_array_equal(t_api.pad_detections(dets[3], 16)[0],
                                  j_pad(dets[3], 16)[0])


@pytest.mark.parametrize("change", [
    dict(appearance_weight=0.3),
    dict(class_aware=True),
    dict(assoc_box="best"),
    dict(auction_warm_start=True),
])
def test_assoc_branches_are_ported(change):
    """The association branches that raised before they were ported build a
    tracker and run a step (tests/test_torch_assoc.py holds them to JAX);
    class_aware pads detections to 6 columns."""
    cfg = t_config.TrackerConfig(max_tracks=4, max_detections=4,
                                 frame_height=48, frame_width=64, **change)
    mt = t_api.MultiTracker(cfg, device="cpu")
    frame = np.zeros((48, 64), np.float32)
    mt.init(frame, np.array([[20.0, 20.0, 8.0, 8.0, 1.0, 2.0]], np.float32))
    assert mt.counters()["births"] == 1
    assert int(mt.bank.cls[0]) == (2 if cfg.class_aware else 0)
    mt.update(frame, np.array([[20.5, 20.0, 8.0, 8.0, 1.0, 2.0],
                               [23.0, 20.0, 8.0, 8.0, 0.9, 1.0]], np.float32))
    c = mt.counters()
    # The second detection overlaps less: it starts a track of its own.
    assert (c["alive"], c["matches"]) == (2, 1)
    assert int(mt.last_output.matched_det[0]) == 0
    warm = cfg.auction_warm_start
    assert bool((mt.bank.auction_col_of >= 0).all()) == warm


@pytest.mark.parametrize("change", [
    dict(kcf=t_config.KCFConfig(scale_step=1.05)),
    dict(kcf=t_config.KCFConfig(feature_type="hog", cell_size=4)),
    dict(train_site="refined"),
    dict(kcf_impl="pallas"),
])
def test_heavy_branches_are_ported(change):
    """The branches that raised before the heavy path was ported build a
    tracker and run a step (tests/test_torch_heavy.py holds them to JAX)."""
    cfg = t_config.TrackerConfig(max_tracks=4, max_detections=4,
                                 frame_height=48, frame_width=64, **change)
    mt = t_api.MultiTracker(cfg, device="cpu")
    frame = np.zeros((48, 64), np.float32)
    mt.init(frame, np.array([[20.0, 20.0, 8.0, 8.0, 1.0]], np.float32))
    assert mt.counters()["births"] == 1
    mt.update(frame, np.zeros((0, 5), np.float32))
    assert mt.counters()["alive"] == 1


def test_entry_points_default_to_the_card():
    """Without a device the entry points take the CUDA card and raise when
    there is none; they never fall back to the CPU."""
    cfg = t_config.TrackerConfig(max_tracks=4, max_detections=4)
    assert t_bank.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert t_api.MultiTracker(cfg).device.type == "cuda"
        return
    for make in (lambda: t_api.MultiTracker(cfg), lambda: t_api.reset(cfg),
                 lambda: t_bank.empty_bank(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_kernel_path_checks_frame_shape():
    cfg = t_config.TrackerConfig(max_tracks=4, max_detections=4,
                                 frame_height=48, frame_width=64,
                                 roi_impl="pallas")
    frame = torch.zeros((40, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="frame shape"):
        t_step.init(frame, torch.zeros((4, 5)),
                    torch.zeros((4,), dtype=torch.bool), cfg)
