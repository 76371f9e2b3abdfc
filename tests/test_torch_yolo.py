"""The port's YOLO family (tpu_mot_torch.models.yolo) against the JAX
package's (tpu_mot.models.yolo) on the CPU, on the same parameters: a
flax-layout tree drawn by interop.numpy_yolo_params and carried into the
port by interop.yolo_params_from_jax.

Tolerances (measured on the CPU, inputs 64x64, 3 classes):
  heads, float32   max |diff| <= 1e-4 of the largest |head| (measured
                   <= 2.9e-6, yolov3 the largest; gray 9.8e-7);
  heads, bfloat16  <= 2e-2 of the largest |head| (measured 4.3e-3 to
                   8.3e-3 on yolov3-tiny and yolov2-tiny: both packages
                   round every block to bfloat16, the convs sum in other
                   orders), and the top detection's score within 5e-3 of
                   JAX's (measured <= 8.2e-5; tests/test_detector.py:305
                   allows 0.05 between bf16 and f32);
  int8             one quantised conv on the same input equal bit for bit
                   (the integer sums are exact in both); a whole net's
                   detections by the geometry rule of
                   tests/test_detector.py:475-479 (a float32 difference in
                   an activation can move one rounding step);
  decode_head      centres within 1e-4 px (measured 7.6e-6), sizes within
                   1e-6 relative (1.6e-7), scores 1e-6 (6e-8), classes equal;
  _maxpool, _reorg, the x2 upsample, the converter round trip: bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mot.models import detector as j_det
from tpu_mot.models import yolo as j_yolo
from tpu_mot_torch import interop
from tpu_mot_torch.models import detector as t_det
from tpu_mot_torch.models import yolo as t_yolo

torch.set_num_threads(1)

VARIANTS = ["yolov3-tiny", "yolov2-tiny", "yolov2", "yolov3"]


def both_specs(name, **kw):
    """(JAX YoloSpec, port YoloSpec) from the same arguments."""
    return j_yolo.YoloSpec(name, **kw), t_yolo.YoloSpec(name, **kw)


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def port_model(spec, tree):
    model = t_yolo.build_model(spec)
    model.load_state_dict(interop.yolo_params_from_jax(tree))
    return model


def heads_both(name, dtype="float32", seed=1, size=64, gray=False):
    """Both packages' heads (NumPy, NHWC) on one seeded input batch."""
    jspec, tspec = both_specs(name, num_classes=3, input_size=size,
                              dtype=dtype)
    tree = interop.numpy_yolo_params(tspec, seed)
    x = np.random.default_rng(seed).random(
        (2, size, size, 1 if gray else 3)).astype(np.float32)
    jx = np.repeat(x, 3, axis=-1) if gray else x
    jh = j_yolo.build_model(jspec).apply(jax_tree(tree), jnp.asarray(jx))
    with torch.no_grad():
        th = port_model(tspec, tree)(torch.as_tensor(x).permute(0, 3, 1, 2))
    return [np.asarray(h) for h in jh], [h.numpy() for h in th]


def test_spec_fields_and_defaults_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(t_yolo.YoloSpec) == fields(j_yolo.YoloSpec)
    for name in VARIANTS:
        assert t_yolo._CANONICAL_ANCHORS[name] == \
            j_yolo._CANONICAL_ANCHORS[name]


SPEC_CASES = [
    ("yolov3-tiny", {}), ("yolov3", {}), ("yolov2", {}), ("yolov2-tiny", {}),
    ("yolov3-tiny", dict(dtype="bfloat16", stem="s2d4")),
    ("yolov2", dict(dtype="int8", stem="direct", num_classes=1)),
    ("yolov3", dict(input_size=96, anchors=j_yolo.YOLOV3_ANCHORS)),
    ("custom", dict(anchors=((1, 2), (3, 4)))),
]


@pytest.mark.parametrize("name,kw", SPEC_CASES)
def test_spec_parity(name, kw):
    jspec, tspec = both_specs(name, **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tspec.strides == jspec.strides
    assert tspec.cls_activation == jspec.cls_activation
    for train in (False, True):
        for hw in (None, (416, 416), (66, 64)):
            assert (t_yolo.resolved_stem(tspec, train, hw)
                    == j_yolo.resolved_stem(jspec, train, hw))


@pytest.mark.parametrize("name,kw", [
    ("yolov9000", {}), ("yolov3", dict(stem="s2d4")),
    ("yolov2", dict(stem="s2d4", dtype="int8")), ("yolov2", dict(stem="x"))])
def test_spec_errors_match(name, kw):
    with pytest.raises(ValueError) as je:
        j_yolo.YoloSpec(name, **kw)
    with pytest.raises(ValueError) as te:
        t_yolo.YoloSpec(name, **kw)
    assert str(te.value) == str(je.value)


def test_build_model_errors_match():
    for make in (lambda m: m.build_model(m.YoloSpec(
            "yolov3", anchors=m.YOLOV3_TINY_ANCHORS)),
                 lambda m: m.build_model(m.YoloSpec(
                     "custom", anchors=((1, 2),)))):
        with pytest.raises(ValueError) as je:
            make(j_yolo)
        with pytest.raises(ValueError) as te:
            make(t_yolo)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", VARIANTS)
def test_heads_match_jax(name):
    jh, th = heads_both(name)
    assert len(th) == len(jh) == len(t_yolo.YoloSpec(name).anchors)
    for a, b in zip(jh, th):
        assert b.shape == a.shape and b.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_gray_input_folds_the_first_kernel():
    """One channel with the first kernel summed over Cin against JAX on the
    replicated channels."""
    jh, th = heads_both("yolov3-tiny", gray=True)
    for a, b in zip(jh, th):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov2-tiny"])
def test_bfloat16_heads_match_jax_bfloat16(name):
    jh, th = heads_both(name, dtype="bfloat16")
    for a, b in zip(jh, th):
        assert np.abs(a - b).max() <= 2e-2 * np.abs(a).max()


def test_bfloat16_top_score_matches_jax():
    frames = np.random.default_rng(4).random((2, 96, 96)).astype(np.float32)
    jspec, tspec = both_specs("yolov2-tiny", num_classes=2, input_size=64,
                              dtype="bfloat16",
                              anchors=j_yolo.YOLOV2_TINY_ANCHORS)
    tree = interop.numpy_yolo_params(tspec, 0)
    jd, _, _ = j_det.detect_batch(jax_tree(tree), jnp.asarray(frames), jspec,
                                  (96, 96), 8, 0.45, 0.0)
    td, _, _ = t_det.detect_batch(port_model(tspec, tree),
                                  torch.as_tensor(frames), (96, 96), 8, 0.45,
                                  0.0)
    assert np.isfinite(td.numpy()).all()
    np.testing.assert_allclose(td.numpy()[:, 0, 4], np.asarray(jd)[:, 0, 4],
                               atol=5e-3)


@pytest.mark.parametrize("stride,cin,gray", [(1, 16, False), (2, 8, False),
                                             (1, 3, True)])
def test_int8_conv_integer_sums_match_jax(stride, cin, gray):
    rng = np.random.default_rng(stride + cin)
    x = (rng.standard_normal((2, 9, 11, 1 if gray else cin)) * [[[[1.0]]],
                                                                [[[7.0]]]]
         ).astype(np.float32)
    w = rng.standard_normal((3, 3, cin, 5)).astype(np.float32)
    jx = np.repeat(x, cin, axis=-1) if gray else x
    conv = j_yolo._QuantConv(5, 3, stride)
    want = conv.apply({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(jx))
    got = t_yolo._quant_conv(torch.as_tensor(x).permute(0, 3, 1, 2),
                             torch.as_tensor(w).permute(3, 2, 0, 1), stride,
                             1, fold_gray=gray)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def _int8_dets(tspec8, tree, frames, hw):
    return [x.numpy() for x in t_det.detect_batch(
        port_model(tspec8, tree), torch.as_tensor(frames), hw, 8, 0.45,
        0.05)]


def test_int8_detections_match_jax_int8():
    """The geometry rule of tests/test_detector.py:475-479, port int8
    against JAX int8 on the same parameters."""
    jspec8, tspec8 = both_specs("yolov3-tiny", num_classes=2, input_size=96,
                                dtype="int8")
    tree = interop.numpy_yolo_params(tspec8, 0)
    frames = np.random.default_rng(0).random((2, 96, 128)).astype(np.float32)
    jd, jv, _ = (np.asarray(a) for a in j_det.detect_batch(
        jax_tree(tree), jnp.asarray(frames), jspec8, (96, 128), 8, 0.45,
        0.05))
    td, tv, _ = _int8_dets(tspec8, tree, frames, (96, 128))
    assert abs(int(tv.sum()) - int(jv.sum())) <= 1
    for b in range(2):
        for i in np.where(jv[b])[0]:
            d = np.linalg.norm(td[b, tv[b], :2] - jd[b, i, :2], axis=1)
            assert d.size and d.min() < 4.0, (b, i, jd[b, i], d.min())


def test_int8_scale_is_per_sample():
    """tests/test_detector.py:487-506 on the port: a bright frame in the
    batch does not change its batchmate's int8 detections."""
    tspec8 = t_yolo.YoloSpec("yolov3-tiny", num_classes=2, input_size=96,
                             dtype="int8")
    tree = interop.numpy_yolo_params(tspec8, 0)
    rng = np.random.default_rng(3)
    dim = rng.random((1, 96, 128)).astype(np.float32) * 0.3
    bright = np.ones((1, 96, 128), np.float32)
    d_solo, v_solo, _ = _int8_dets(tspec8, tree, dim, (96, 128))
    d_pair, v_pair, _ = _int8_dets(tspec8, tree,
                                   np.concatenate([dim, bright]), (96, 128))
    np.testing.assert_array_equal(v_solo[0], v_pair[0])
    np.testing.assert_allclose(d_solo[0], d_pair[0], atol=1e-5)


@pytest.mark.parametrize("stride,h,w", [(2, 6, 8), (2, 5, 7), (1, 4, 6),
                                        (1, 3, 5)])
def test_maxpool_matches_flax(stride, h, w):
    x = np.random.default_rng(h * w).standard_normal(
        (2, h, w, 3)).astype(np.float32)
    want = np.asarray(j_yolo._maxpool(jnp.asarray(x), stride))
    got = t_yolo._maxpool(torch.as_tensor(x).permute(0, 3, 1, 2), stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_reorg_and_upsample_match_jax():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(
        t_yolo._reorg(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(j_yolo._reorg(jnp.asarray(x))))
    up = jax.image.resize(jnp.asarray(x), (2, 8, 12, 3), "nearest")
    np.testing.assert_array_equal(
        t_yolo._upsample2(xt).permute(0, 2, 3, 1).numpy(), np.asarray(up))


def test_stride2_conv_taps_darknet_alignment():
    """tests/test_detector.py:509-526 on the port: with a delta kernel at
    the window centre, output row j reads input row 2j (darknet), not
    2j+1 (XLA SAME)."""
    blk = t_yolo.ConvBlock(1, 1, kernel=3, stride=2, use_bn=False,
                           act=False).eval()
    with torch.no_grad():
        blk.conv.weight.zero_()
        blk.conv.weight[0, 0, 1, 1] = 1.0
        blk.conv.bias.zero_()
        x = torch.arange(8.0).reshape(1, 1, 8, 1).repeat(1, 1, 1, 2)
        y = blk(x)
    np.testing.assert_array_equal(y[0, 0, :, 0].numpy(), [0.0, 2.0, 4.0, 6.0])


def test_training_mode_raises():
    """Training mode runs in float32 and bfloat16 (tests/test_torch_train.py
    holds it to flax); an int8 net refuses it: its rounding has no
    gradient."""
    model = t_yolo.build_model(t_yolo.YoloSpec("yolov2-tiny", input_size=64,
                                               dtype="int8"))
    model.train()
    with pytest.raises(ValueError, match="inference-only"):
        model(torch.zeros((1, 3, 64, 64)))


@pytest.mark.parametrize("nc,act", [(3, "sigmoid"), (4, "softmax"),
                                    (1, "softmax")])
def test_decode_head_matches_jax(nc, act):
    anchors = ((20, 30), (40, 60), (81, 82))
    raw = (np.random.default_rng(nc).standard_normal(
        (2, 5, 7, 3 * (5 + nc))) * 2.0).astype(np.float32)
    raw[0, 1, 2, 5:5 + nc] = 1.5            # tied class logits: first wins
    jb, js, jc = (np.asarray(a) for a in j_yolo.decode_head(
        jnp.asarray(raw), anchors, 16, nc, 96, cls_act=act))
    tb, ts, tc = (a.numpy() for a in t_yolo.decode_head(
        torch.as_tensor(raw), anchors, 16, nc, 96, cls_act=act))
    np.testing.assert_allclose(tb[..., :2], jb[..., :2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb[..., 2:], jb[..., 2:], rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("name", VARIANTS)
def test_converter_round_trip(name):
    """tree -> the port's state dict -> tree, bit-equal, and the state dict
    loads strictly into the port's net (test_heads_match_jax feeds the same
    tree to flax, which checks every shape)."""
    spec = t_yolo.YoloSpec(name, num_classes=2, input_size=64)
    tree = interop.numpy_yolo_params(spec, 5)
    sd = interop.yolo_params_from_jax(tree)
    t_yolo.build_model(spec).load_state_dict(sd)
    back = interop.yolo_params_to_jax(sd)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    assert flat(back).keys() == flat(tree).keys()
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(flat(back)[k], v, err_msg=str(k))
