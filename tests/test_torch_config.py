"""The port's own copies of the JAX package's JAX-free modules against the
originals: tpu_mot_torch.config (fields, defaults, validation, resolved
properties), tpu_mot_torch.data.synthetic (bit-identical fixtures) and
tpu_mot_torch.utils.metrics (identical CLEAR-MOT and HOTA numbers).

`both_configs` builds one TrackerConfig in each package from the same
keyword arguments; the other parity test files use it.
"""

import dataclasses

import numpy as np
import pytest

from tpu_mot import config as j_config
from tpu_mot.data import synthetic as j_synth
from tpu_mot.utils import metrics as j_metrics
from tpu_mot_torch import config as t_config
from tpu_mot_torch.data import synthetic as t_synth
from tpu_mot_torch.utils import metrics as t_metrics


def both_configs(kcf=None, **kw):
    """(JAX TrackerConfig, port TrackerConfig) from the same keyword
    arguments; `kcf` is a dict of KCFConfig arguments."""
    kcf = kcf or {}
    return (j_config.TrackerConfig(kcf=j_config.KCFConfig(**kcf), **kw),
            t_config.TrackerConfig(kcf=t_config.KCFConfig(**kcf), **kw))


def _fields(cls):
    """(name, default) of each field; a dataclass default as a dict."""
    return [(f.name, dataclasses.asdict(f.default)
             if dataclasses.is_dataclass(f.default) else f.default)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["KCFConfig", "KalmanConfig",
                                  "TrackerConfig"])
def test_config_fields_and_defaults_match(name):
    assert _fields(getattr(t_config, name)) == _fields(getattr(j_config,
                                                               name))
    assert (dataclasses.asdict(t_config.DEFAULT_CONFIG)
            == dataclasses.asdict(j_config.DEFAULT_CONFIG))


CASES = [
    dict(),
    dict(kcf=dict(feature_type="hog", cell_size=4, scale_step=1.05)),
    dict(kcf=dict(feature_type="hog", cell_size=4, scale_step=1.05),
         kcf_impl="pallas", train_site="refined"),
    dict(kcf=dict(template_size=32), class_aware=True,
         confidence_mode="peak", kcf_precision="default"),
    dict(assoc_box="predicted", min_psr=3.0, kcf_impl="xla"),
]


@pytest.mark.parametrize("kw", CASES)
def test_config_resolved_properties_match(kw):
    jc, tc = both_configs(**kw)
    for attr in ("feature_size", "num_channels", "spectrum_width"):
        assert getattr(tc.kcf, attr) == getattr(jc.kcf, attr), attr
    for attr in ("kcf_precision_resolved", "assoc_box_resolved",
                 "confidence_threshold"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (dataclasses.asdict(tc.replace(max_tracks=7))
            == dataclasses.asdict(jc.replace(max_tracks=7)))


@pytest.mark.parametrize("kw", [
    dict(kcf=dict(template_size=30, cell_size=4)),
    dict(kcf=dict(template_size=4, cell_size=4)),
    dict(kcf=dict(feature_type="sift")),
    dict(kcf=dict(padding=0.0)),
    dict(kcf=dict(scale_step=0.9)),
    dict(train_site="nowhere"),
    dict(roi_impl="cuda"),
    dict(kcf_impl="pallas", kcf_precision="fwd_high"),
    dict(kcf_block=0),
    dict(max_tracks=0),
    dict(frame_height=0),
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError) as j_err:
        j_config.TrackerConfig(kcf=j_config.KCFConfig(**kw.get("kcf", {})),
                               **{k: v for k, v in kw.items() if k != "kcf"})
    with pytest.raises(ValueError) as t_err:
        t_config.TrackerConfig(kcf=t_config.KCFConfig(**kw.get("kcf", {})),
                               **{k: v for k, v in kw.items() if k != "kcf"})
    assert str(t_err.value) == str(j_err.value)


def test_synthetic_fixture_bit_identical():
    for seed, kw in [(0, dict(min_size=24, max_size=64, max_speed=3.0)),
                     (42, dict(max_speed=2.5)),
                     (7, dict(lifespan=(0, 5), n_classes=3))]:
        objs = [j_synth.make_objects(9, 120, 160,
                                     np.random.default_rng(seed), **kw),
                t_synth.make_objects(9, 120, 160,
                                     np.random.default_rng(seed), **kw)]
        assert [dataclasses.asdict(o) for o in objs[0]] == [
            dataclasses.asdict(o) for o in objs[1]]
        jf, jb, jv = j_synth.render_sequence(objs[0], 6, 120, 160, seed=seed)
        tf, tb, tv = t_synth.render_sequence(objs[1], 6, 120, 160, seed=seed)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tv, jv)
        classes = [o.cls for o in objs[0]]
        for kw_d in (dict(), dict(drop_prob=0.2, fp_per_frame=1.5,
                                  classes=classes)):
            jd = j_synth.detections_from_gt(jb, jv, seed=seed,
                                            frame_hw=(120, 160), **kw_d)
            td = t_synth.detections_from_gt(tb, tv, seed=seed,
                                            frame_hw=(120, 160), **kw_d)
            assert len(jd) == len(td)
            for a, b in zip(jd, td):
                np.testing.assert_array_equal(b, a)
    centers = np.random.default_rng(3).uniform(20, 100, (5, 2, 2))
    sizes = np.array([[12.0, 10.0], [20.0, 16.0]])
    for a, b in zip(j_synth.render_trajectories(centers, sizes, 120, 160),
                    t_synth.render_trajectories(centers, sizes, 120, 160)):
        np.testing.assert_array_equal(b, a)


def test_metrics_identical():
    rng = np.random.default_rng(5)
    gt, hyp = [], []
    for f in range(12):
        ids = np.arange(6)
        boxes = np.stack([rng.uniform(20, 200, 6), rng.uniform(20, 200, 6),
                          rng.uniform(10, 30, 6), rng.uniform(10, 30, 6)], 1)
        gt.append((ids, boxes))
        keep = rng.random(6) < 0.8
        h_ids = np.where(keep)[0] + (f > 6) * 10        # an id switch
        h_boxes = boxes[keep] + rng.normal(0, 2, (keep.sum(), 4))
        if f % 4 == 0:                                   # a false positive
            h_ids = np.append(h_ids, 99)
            h_boxes = np.vstack([h_boxes, [[5.0, 5.0, 8.0, 8.0]]])
        hyp.append((h_ids, h_boxes))
    assert t_metrics.clear_mot(gt, hyp) == j_metrics.clear_mot(gt, hyp)
    got, want = t_metrics.hota(gt, hyp), j_metrics.hota(gt, hyp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert t_metrics.hota([], [])["hota"] == j_metrics.hota([], [])["hota"]
