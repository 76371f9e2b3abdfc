"""The port's detector (tpu_mot_torch.models.detector) and its strided
detect -> track scans against the JAX package on the CPU, on the same
seeded parameters (interop.numpy_yolo_params):

  (a) preprocess, heads and the decoded candidates before NMS on gray u8,
      gray float and 3-channel frames: net input within 1e-5 (the
      antialiased resize; measured <= 2.4e-7), heads within 1e-4 of the
      largest |head|, boxes within 1e-5 relative + 1e-3 px, scores 1e-5,
      classes equal;
  (b) NMS index for index: JAX's class-wise NMS run on the PORT's decoded
      candidates gives the port's detections exactly (random weights make
      near-ties that float rounding between two conv implementations can
      reorder, so the two NMS are fed the same candidates);
  (c) checkpoints written by either package load in the other; a darknet
      file the test writes loads into the right places;
  (d) the strided scans: equal to the port's own run_sequence fed the
      detections of the stride frames (ids and valid exact, boxes within
      0.05 px), N = 6 and 7, stride 3; and equal to JAX's strided scans
      when both are fed the JAX detector's detections;
  (e) the e2e dump's tracks from the JAX bank it keeps, and chip_smoke.py's
      lockstep and track comparison.

The dump of the JAX reference on bench_e2e.py's fixture, which
chip_smoke.py holds the port to on the card, is regenerated by

    python tests/test_torch_detector.py regen-e2e-dump
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import functools

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
from tpu_mot.ops.nms import nms_classwise as j_nms_classwise
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import scan as j_scan
from tpu_mot_torch import interop
from tpu_mot_torch.models import detector as t_det
from tpu_mot_torch.models import yolo as t_yolo
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import scan as t_scan

torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnames=("spec", "frame_hw"))
def jax_candidates(params, frames, spec, frame_hw):
    """tpu_mot.models.detector.detect_batch up to NMS (detector.py:44-82):
    (net input, heads, boxes in frame pixels, scores, classes)."""
    pre = jnp.bfloat16 if spec.dtype == "bfloat16" else jnp.float32
    f = frames.astype(pre)
    if frames.dtype == jnp.uint8:
        f = f / 255.0
    s = spec.input_size
    if f.ndim == 3:
        f = jax.image.resize(f, (f.shape[0], s, s), "bilinear")
        if j_yolo.resolved_stem(spec, hw=(s, s)) == "s2d4":
            f = f[..., None].astype(jnp.float32)
        else:
            f = jnp.repeat(f[..., None], 3, axis=-1).astype(jnp.float32)
    else:
        f = jax.image.resize(f, (f.shape[0], s, s, 3),
                             "bilinear").astype(jnp.float32)
    heads = j_yolo.build_model(spec).apply(params, f)
    parts = [j_yolo.decode_head(h, a, st, spec.num_classes, s,
                                cls_act=spec.cls_activation)
             for h, a, st in zip(heads, spec.anchors, spec.strides)]
    boxes, scores, classes = (jnp.concatenate(p, axis=1) for p in zip(*parts))
    h, w = frame_hw
    boxes = boxes * jnp.asarray([w / s, h / s, w / s, h / s], jnp.float32)
    return f, heads, boxes, scores, classes


def jax_select(boxes, scores, classes, max_out, iou_thr, score_thr,
               impl="greedy"):
    """detector.py:84-93 (JAX's class-wise NMS and gather per frame) on
    given candidates, as NumPy."""
    def one(bx, sc, cl):
        idx, valid = j_nms_classwise(bx, sc, cl, max_out, iou_thr, score_thr,
                                     impl=impl)
        safe = jnp.clip(idx, 0, bx.shape[0] - 1)
        dets = jnp.concatenate(
            [bx[safe], jnp.where(valid, sc[safe], 0.0)[:, None]], axis=1)
        return dets, valid, jnp.where(valid, cl[safe], -1)
    return [np.asarray(x) for x in jax.vmap(one)(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))]


FRAME_KINDS = {
    "gray u8": lambda rng: (rng.random((2, 96, 128)) * 255).astype(np.uint8),
    "gray float": lambda rng: rng.random((2, 96, 128)).astype(np.float32),
    "rgb u8": lambda rng: (rng.random((2, 96, 128, 3)) * 255).astype(
        np.uint8),
}


@pytest.mark.parametrize("kind", list(FRAME_KINDS))
def test_detect_batch_matches_jax(kind):
    jspec, tspec = both_specs("yolov3-tiny", num_classes=3, input_size=64)
    tree = interop.numpy_yolo_params(tspec, 2)
    frames = FRAME_KINDS[kind](np.random.default_rng(7))
    x, heads, boxes, scores, classes = (jax.tree.map(np.asarray, v) for v in
                                        jax_candidates(jax_tree(tree),
                                                       jnp.asarray(frames),
                                                       jspec, (96, 128)))
    det = t_det.YoloDetector(tspec, interop.yolo_params_from_jax(tree),
                             max_out=16, score_thr=0.2, device="cpu")
    ft = torch.as_tensor(frames)
    tx = t_det.preprocess(ft, tspec).permute(0, 2, 3, 1).numpy()
    assert tx.shape[-1] == (3 if frames.ndim == 4 else 1)
    assert np.abs(tx - x[..., : tx.shape[-1]]).max() <= 1e-5
    with torch.no_grad():
        th = det.model(torch.as_tensor(x.copy()).permute(0, 3, 1, 2))
    for a, b in zip(heads, th):
        assert np.abs(a - b.numpy()).max() <= 1e-4 * np.abs(a).max()
    tb, ts, tc = (a.numpy() for a in t_det.decode_frames(det.model, ft,
                                                         (96, 128)))
    np.testing.assert_allclose(tb, boxes, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ts, scores, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc, classes)
    got = {}
    for impl in ("greedy", "fast"):
        got[impl] = [a.numpy() for a in t_det.detect_batch(
            det.model, ft, (96, 128), 16, 0.45, 0.2, nms_impl=impl)]
        want = jax_select(tb, ts, tc, 16, 0.45, 0.2, impl)
        assert got[impl][1].any()
        for g, w in zip(got[impl], want):
            np.testing.assert_array_equal(g, w)
    batch = det.detect(frames)
    one = det.detect(frames[0])
    assert batch[0].shape == (2, 16, 5) and one[0].shape == (16, 5)
    for g, b in zip(got["greedy"], batch):
        np.testing.assert_array_equal(b, g)
    # one frame alone: the CPU's convolutions may sum in another order at
    # another batch size
    np.testing.assert_allclose(one[0], got["greedy"][0][0], rtol=1e-5)
    for g, o in zip(got["greedy"][1:], one[1:]):
        np.testing.assert_array_equal(o, g[0])


def test_dets_with_classes():
    dets = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    cls = torch.tensor([[0, 7, -1], [2, 1, 0]], dtype=torch.int32)
    got = t_det.dets_with_classes(dets, cls)
    want = j_det.dets_with_classes(jnp.asarray(dets.numpy()),
                                   jnp.asarray(cls.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_device_is_the_card():
    spec = t_yolo.YoloSpec("yolov2-tiny", num_classes=1, input_size=64)
    if torch.cuda.is_available():
        assert t_det.YoloDetector.random_init(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_det.YoloDetector.random_init(spec)
    det = t_det.YoloDetector.random_init(spec, device="cpu")
    with pytest.raises(ValueError, match="frames' device"):
        t_det.detect_batch(det.model, torch.zeros((1, 64, 64),
                                                  device="meta"), (64, 64))


def test_checkpoints_load_across_packages(tmp_path):
    jspec, tspec = both_specs("yolov3-tiny", num_classes=2, input_size=64)
    tdet = t_det.YoloDetector.random_init(tspec, seed=3, device="cpu")
    tdet.save(str(tmp_path / "port.npz"))
    jdet = j_det.YoloDetector.load(jspec, str(tmp_path / "port.npz"))
    want = interop.numpy_yolo_params(tspec, 3)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    for k, v in flat(want).items():
        np.testing.assert_array_equal(np.asarray(flat(jdet.params)[k]), v)
    jdet2 = j_det.YoloDetector.random_init(jspec, seed=1)
    jdet2.save(str(tmp_path / "jax.npz"))
    back = t_det.YoloDetector.load(tspec, str(tmp_path / "jax.npz"),
                                   device="cpu")
    sd = interop.yolo_params_from_jax(jax.tree.map(np.asarray, jdet2.params))
    for k, v in back.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def write_darknet(path, spec, rng):
    """A darknet .weights file of random values for spec's layout (as
    tests/test_detector.py:217 writes it) -> the flax tree it encodes."""
    shapes = {n: s for n, s, _ in t_yolo.layer_shapes(spec)}
    chunks = [np.asarray([0, 2, 0], np.int32).tobytes(),
              np.asarray([0], np.int64).tobytes()]
    params, stats = {}, {}
    for name, use_bn in t_det._conv_layers_in_call_order(spec):
        kh, kw, ci, co = shapes[name]
        arrs = [rng.standard_normal(co).astype(np.float32)
                for _ in range(4 if use_bn else 1)]
        w = rng.standard_normal((co, ci, kh, kw)).astype(np.float32)
        chunks += [a.tobytes() for a in arrs] + [w.tobytes()]
        params[name] = {"conv": {"kernel": np.transpose(w, (2, 3, 1, 0))}}
        if use_bn:
            params[name]["bn"] = {"bias": arrs[0], "scale": arrs[1]}
            stats[name] = {"bn": {"mean": arrs[2], "var": arrs[3]}}
        else:
            params[name]["conv"]["bias"] = arrs[0]
    path.write_bytes(b"".join(chunks))
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("name", ["yolov2-tiny", "yolov3-tiny", "yolov2",
                                  "yolov3"])
def test_darknet_weight_roundtrip(tmp_path, name):
    spec = t_yolo.YoloSpec(name, num_classes=2, input_size=96)
    want = write_darknet(tmp_path / "w.weights", spec,
                         np.random.default_rng(0))
    got = interop.yolo_params_to_jax(
        t_det.load_darknet_weights(spec, str(tmp_path / "w.weights")))
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    assert flat(got).keys() == flat(want).keys()
    for k, v in flat(want).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=str(k))
    det = t_det.YoloDetector.from_darknet(spec, str(tmp_path / "w.weights"),
                                          device="cpu")
    np.testing.assert_array_equal(
        det.model.ConvBlock_0.conv.weight.detach().numpy(),
        np.transpose(want["params"]["ConvBlock_0"]["conv"]["kernel"],
                     (3, 2, 0, 1)))


def test_darknet_errors(tmp_path):
    spec = t_yolo.YoloSpec("yolov2-tiny", num_classes=2, input_size=96)
    path = tmp_path / "w.weights"
    write_darknet(path, spec, np.random.default_rng(1))
    data = path.read_bytes()
    path.write_bytes(data[:-8])
    with pytest.raises(ValueError, match="truncated"):
        t_det.load_darknet_weights(spec, str(path))
    path.write_bytes(data + np.zeros(3, np.float32).tobytes())
    with pytest.raises(ValueError, match="3 unconsumed floats"):
        t_det.load_darknet_weights(spec, str(path))


STRIDE = 3


def strided_setup(n):
    """tests/test_detector.py:360-447's case: yolov2-tiny (1 class, 64),
    8 slots, 96 x 128 float frames, score 0.2."""
    jspec, tspec = both_specs("yolov2-tiny", num_classes=1, input_size=64,
                              anchors=j_yolo.YOLOV2_TINY_ANCHORS)
    tree = interop.numpy_yolo_params(tspec, 0)
    jcfg, tcfg = both_configs(max_tracks=8, max_detections=8,
                              frame_height=96, frame_width=128,
                              roi_impl="xla")
    frames = np.random.default_rng(2).random((7, 96, 128)).astype(
        np.float32)[:n]
    return jspec, tspec, tree, jcfg, tcfg, frames


def assert_outputs_equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got.ids), np.asarray(want.ids),
                                  err_msg=what)
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(want.valid), err_msg=what)
    np.testing.assert_allclose(np.asarray(got.boxes), np.asarray(want.boxes),
                               rtol=0, atol=0.05, err_msg=what)


def masked(dets, valid, n):
    mask = (np.arange(n) % STRIDE) == 0
    return dets * mask[:, None, None], valid & mask[:, None]


@pytest.mark.parametrize("n", [6, 7])
def test_strided_scans_equal_run_sequence(n):
    """The port's strided scans against its own run_sequence fed the
    detector's detections on the stride frames and none elsewhere."""
    _, tspec, tree, _, cfg, frames = strided_setup(n)
    det = t_det.YoloDetector(tspec, interop.yolo_params_from_jax(tree),
                             device="cpu")
    ft = torch.as_tensor(frames)
    d, v, _ = t_det.detect_batch(det.model, ft, (96, 128), 8, 0.45, 0.2)
    d, v = masked(d.numpy(), v.numpy(), n)
    assert v.any()
    bank0 = t_bank.empty_bank(cfg, device="cpu")
    _, ref = t_scan.run_sequence(bank0, ft, torch.as_tensor(d),
                                 torch.as_tensor(v), cfg)
    for fn in (t_scan.run_sequence_strided_detector,
               t_scan.run_sequence_strided_batched):
        _, out = fn(bank0, ft, det.model, cfg, STRIDE, score_thr=0.2)
        assert_outputs_equal(out, ref, f"{fn.__name__} n={n}")
    ccfg = cfg.replace(class_aware=True)
    _, out = t_scan.run_sequence_strided_batched(
        t_bank.empty_bank(ccfg, device="cpu"), ft, det.model, ccfg, STRIDE,
        score_thr=0.2)
    assert out.valid.any() and (out.cls[out.valid] == 0).all()


@pytest.mark.parametrize("which", ["detector", "batched"])
@pytest.mark.parametrize("n", [6, 7])
def test_strided_scans_match_jax(monkeypatch, which, n):
    """Both packages' strided scans fed the JAX detector's detections (the
    port's detector call is replaced by JAX's detect_batch on the same
    frames): the same ids, valid and boxes."""
    jspec, tspec, tree, jcfg, tcfg, frames = strided_setup(n)
    params = jax_tree(tree)

    def jax_detect(model, fr, cfg, iou_thr, score_thr, nms_impl):
        d, v, _ = j_det.detect_batch(params, jnp.asarray(fr.numpy()), jspec,
                                     (96, 128), 8, iou_thr, score_thr,
                                     nms_impl=nms_impl)
        return torch.as_tensor(np.array(d)), torch.as_tensor(np.array(v))

    monkeypatch.setattr(t_scan, "_detect", jax_detect)
    jfn = getattr(j_scan, f"run_sequence_strided_{which}")
    tfn = getattr(t_scan, f"run_sequence_strided_{which}")
    _, want = jfn(j_bank.empty_bank(jcfg), jnp.asarray(frames), params, jcfg,
                  jspec, STRIDE, score_thr=0.2)
    det = t_det.YoloDetector(tspec, interop.yolo_params_from_jax(tree),
                             device="cpu")
    _, got = tfn(t_bank.empty_bank(tcfg, device="cpu"),
                 torch.as_tensor(frames), det.model, tcfg, STRIDE,
                 score_thr=0.2)
    assert np.asarray(want.valid).any()
    assert_outputs_equal(got, want, f"{which} n={n}")


def test_e2e_dump_layout():
    """The committed JAX dump that chip_smoke.py's e2e-detect phase reads."""
    dump = np.load(chip_smoke.E2E_DUMP)
    n, d, t = chip_smoke.E2E_FRAMES, chip_smoke.E2E_DETS, 128
    shapes = {"dets": (n, d, 5), "valid": (n, d), "classes": (n, d),
              "pre_boxes": (chip_smoke.E2E_PRE, 2535, 4),
              "pre_scores": (chip_smoke.E2E_PRE, 2535),
              "pre_classes": (chip_smoke.E2E_PRE, 2535),
              "ids": (n, t), "track_valid": (n, t), "boxes": (n, t, 4)}
    for k, shape in shapes.items():
        assert dump[k].shape == shape, k
    assert dump["valid"].sum() > 0 and dump["track_valid"].sum() > 0
    assert (dump["classes"][~dump["valid"]] == -1).all()
    bank = chip_smoke.dump_bank(dump, "cpu")
    empty = t_bank.empty_bank(chip_smoke.e2e_fixture()[3], device="cpu")
    for name in t_bank.TrackBank._fields:
        for got, like in zip(torch.utils._pytree.tree_leaves(
                getattr(bank, name)), torch.utils._pytree.tree_leaves(
                getattr(empty, name))):
            assert got.shape == like.shape and got.dtype == like.dtype, name
    assert int(bank.frame_idx) == chip_smoke.E2E_BANK_FRAME


def test_tracker_from_jax_bank_matches_dump():
    """The port on the CPU, stepped from the JAX bank the dump keeps, gives
    the dump's tracks on the frames after it (ids and valid exact, boxes
    within 0.05 px; measured 7.6e-4 px), as chip_smoke.py holds the card.
    roi_impl="pallas" samples the pyramid on the CPU, as K1 does on the
    card and the JAX run did."""
    torch.set_num_threads(4)
    try:
        frames_u8, _, _, cfg, _ = chip_smoke.e2e_fixture()
        cfg = cfg.replace(roi_impl="pallas")
        dump = np.load(chip_smoke.E2E_DUMP)
        k = chip_smoke.E2E_BANK_FRAME
        _, out = t_scan.run_sequence(
            chip_smoke.dump_bank(dump, "cpu"), torch.as_tensor(frames_u8[k:]),
            torch.as_tensor(dump["dets"][k:]),
            torch.as_tensor(dump["valid"][k:]), cfg)
    finally:
        torch.set_num_threads(1)
    ref = (dump["ids"][k:], dump["track_valid"][k:], dump["boxes"][k:])
    ok, txt = chip_smoke.compare_tracks(chip_smoke.triple(out), ref, start=k)
    assert ok, txt


def test_lockstep_and_compare_tracks():
    """chip_smoke.lockstep: the first set's steps equal run_sequence on it,
    the second set's are each one step from that bank; compare_tracks
    finds a box moved past its tolerance and a changed id."""
    _, tspec, tree, _, cfg, frames = strided_setup(7)
    det = t_det.YoloDetector(tspec, interop.yolo_params_from_jax(tree),
                             device="cpu")
    ft = torch.as_tensor(frames)
    d, v, _ = t_det.detect_batch(det.model, ft, (96, 128), 8, 0.45, 0.2)
    bank0 = t_bank.empty_bank(cfg, device="cpu")
    _, ref = t_scan.run_sequence(bank0, ft, d, v, cfg)
    moved = d.clone()
    moved[3, :, :2] += 0.01
    first, second = chip_smoke.lockstep(bank0, ft, d, v, moved, v, cfg)
    assert_outputs_equal(first, ref, "lockstep, first set")
    assert ref.valid.any()
    ok, txt = chip_smoke.compare_tracks(chip_smoke.triple(second),
                                        chip_smoke.triple(first))
    assert ok, txt
    assert not torch.equal(first.boxes[3], second.boxes[3])
    assert torch.equal(first.boxes[4:], second.boxes[4:])
    ids, valid, boxes = chip_smoke.triple(ref)
    far = boxes.copy()
    f, t = np.argwhere(valid)[0]
    far[f, t, 0] += 0.06
    ok, txt = chip_smoke.compare_tracks((ids, valid, far), (ids, valid,
                                                            boxes), start=5)
    assert not ok and f"first frame over 0.05 px: {5 + f}" in txt
    excused = np.zeros_like(valid)
    excused[f, t] = True
    ok, txt = chip_smoke.compare_tracks((ids, valid, far), (ids, valid,
                                                            boxes),
                                        excused=excused)
    assert ok and "1 excused over 0.05 px" in txt
    other = ids.copy()
    other[f, t] += 1
    assert not chip_smoke.compare_tracks((other, valid, boxes),
                                         (ids, valid, boxes))[0]


def regen_e2e_dump():
    """Run the JAX reference (tpu_mot on the CPU) over chip_smoke.py's
    bench_e2e fixture: detect_batch with numpy_yolo_params(yolov3-tiny,
    seed 0) in chunks of 4 frames, then run_sequence with
    roi_impl="pallas" (the interpret-mode ROI kernel samples the pyramid
    level the card samples) on its detections.  The tracker's bank after
    frame E2E_BANK_FRAME - 1 is kept too ("bank_" keys; spectra as re/im
    pairs), so the port can step the last frames from JAX's own state."""
    jax.config.update("jax_platforms", "cpu")
    frames_u8, _, _, cfg, tspec = chip_smoke.e2e_fixture()
    # bench_e2e.py:81-82 runs the direct stem unless TPU_MOT_STEM says
    # otherwise
    jspec = j_yolo.YoloSpec(tspec.name, num_classes=tspec.num_classes,
                            stem="direct")
    params = jax_tree(interop.numpy_yolo_params(tspec, chip_smoke.E2E_SEED))
    hw = (cfg.frame_height, cfg.frame_width)
    outs = [j_det.detect_batch(params, jnp.asarray(frames_u8[i:i + 4]),
                               jspec, hw, cfg.max_detections,
                               chip_smoke.E2E_IOU, chip_smoke.E2E_SCORE)
            for i in range(0, len(frames_u8), 4)]
    dets, valid, classes = (np.concatenate([np.asarray(o[k]) for o in outs])
                            for k in range(3))
    _, _, pre_boxes, pre_scores, pre_classes = jax_candidates(
        params, jnp.asarray(frames_u8[:chip_smoke.E2E_PRE]), jspec, hw)
    jcfg, _ = both_configs(max_tracks=cfg.max_tracks,
                           max_detections=cfg.max_detections,
                           frame_height=hw[0], frame_width=hw[1],
                           roi_impl="pallas")
    # two scans split at E2E_BANK_FRAME, so the bank between them is kept
    k = chip_smoke.E2E_BANK_FRAME
    bank = j_bank.empty_bank(jcfg)
    parts = []
    for sl in (slice(0, k), slice(k, None)):
        if sl.start == k:
            kept = bank
        bank, o = j_scan.run_sequence(bank, jnp.asarray(frames_u8[sl]),
                                      jnp.asarray(dets[sl]),
                                      jnp.asarray(valid[sl]), jcfg)
        parts.append(o)
    out = {"dets": dets.astype(np.float32), "valid": valid.astype(bool),
           "classes": classes.astype(np.int32),
           "pre_boxes": np.asarray(pre_boxes, np.float32),
           "pre_scores": np.asarray(pre_scores, np.float32),
           "pre_classes": np.asarray(pre_classes, np.int32),
           "ids": np.concatenate([np.asarray(o.ids, np.int32)
                                  for o in parts]),
           "track_valid": np.concatenate([np.asarray(o.valid, bool)
                                          for o in parts]),
           "boxes": np.concatenate([np.asarray(o.boxes, np.float32)
                                    for o in parts])}
    for name in j_bank.TrackBank._fields:
        if name == "kcf":
            for part in ("xf", "alphaf"):
                cf = getattr(kept.kcf, part)
                out[f"bank_{part}_re"] = np.asarray(cf.re)
                out[f"bank_{part}_im"] = np.asarray(cf.im)
        else:
            out[f"bank_{name}"] = np.asarray(getattr(kept, name))
    print(f"detections per frame: {valid.sum(1).tolist()}; scores "
          f"{dets[..., 4][valid].min():.6f}-{dets[..., 4][valid].max():.6f};"
          f" {int(out['track_valid'].sum())} valid slot-frames")
    np.savez_compressed(chip_smoke.E2E_DUMP, **out)
    print(f"wrote {chip_smoke.E2E_DUMP}")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen-e2e-dump"]:
        regen_e2e_dump()
