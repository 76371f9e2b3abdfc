"""The port's heavy tracker path (fHOG-31 features, the 3-scale search,
the fused KCF kernels, refined-site training) against the JAX tracker on
the CPU.

  (a) the port reproduces tests/golden/mot_synthetic_hog_scale_v1.npz on
      test_golden.py's fixture with its tolerances (ids and valid exact,
      boxes atol 1e-3);
  (b) HF at a small size (120 x 160 u8, 8 slots, 8 frames, template 32):
      JAX runs its Pallas kernels (K1, K2, K3, K4, K5) in interpret mode,
      the port the kernels' plain versions; ids and valid exact, boxes atol
      1e-3, frame by frame.  Also kcf_impl="pallas" with detect-site
      training, where the detect spectrum is recomputed for training;
  (c) a heavy mid-sequence bank (C=31, S=16) carried over by interop and
      stepped once in both packages.

The bench-fixture dump of the JAX reference in the heavy modes, which
chip_smoke.py holds the port to on the card, is regenerated by

    python tests/test_torch_heavy.py regen-bench-dump
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

import chip_smoke
from test_golden import GOLDEN_HEAVY, _check
from test_torch_config import both_configs
from test_torch_tracker import _fixture, _jax_bank, _np_out, _padded
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import scan as j_scan
from tpu_mot.tracker import step as j_step
from tpu_mot_torch import interop
from tpu_mot_torch.kernels import auction as t_auction
from tpu_mot_torch.kernels import kcf as t_kcfk
from tpu_mot_torch.kernels import roi as t_roi
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import scan as t_scan
from tpu_mot_torch.tracker import step as t_step

torch.set_num_threads(1)

HEAVY_KCF = chip_smoke.HEAVY_KCF       # fHOG-31 over 4x4 cells, 3 scales


def _golden_heavy_inputs(**kw):
    frames, dets = _fixture(42, 10, 25, 240, 320, max_speed=2.5)
    jcfg, tcfg = both_configs(
        kcf=HEAVY_KCF, max_tracks=32, max_detections=16, frame_height=240,
        frame_width=320, roi_impl="xla", **kw)
    return frames, dets, jcfg, tcfg


def test_golden_mot_dump_hog_scale():
    frames, dets, _, cfg = _golden_heavy_inputs()
    d, v = _padded(dets, cfg.max_detections)
    _, out = t_scan.run_sequence(
        t_bank.empty_bank(cfg, device="cpu"), torch.as_tensor(frames),
        torch.as_tensor(d), torch.as_tensor(v), cfg)
    assert out.valid.numpy().any()
    _check(_np_out(out), GOLDEN_HEAVY)


@pytest.mark.parametrize("train_site", ["refined", "detect"])
def test_fused_heavy_path_matches_jax_interpret(train_site):
    h, w = 120, 160
    frames, dets = _fixture(11, 6, 8, h, w, min_size=12, max_size=24,
                            max_speed=2.0)
    frames_u8 = (frames * 255).astype(np.uint8)
    jcfg, tcfg = both_configs(
        kcf=dict(HEAVY_KCF, template_size=32), max_tracks=8,
        max_detections=8, frame_height=h, frame_width=w, roi_impl="pallas",
        assign_impl="pallas", kcf_impl="pallas", train_site=train_site)
    d, v = _padded(dets, tcfg.max_detections)
    _, jo = j_scan.run_sequence(j_bank.empty_bank(jcfg),
                                jnp.asarray(frames_u8), jnp.asarray(d),
                                jnp.asarray(v), jcfg)
    counts = (t_roi.launches, t_roi.launches_scales, t_auction.launches,
              t_kcfk.launches_detect, t_kcfk.launches_train)
    _, to = t_scan.run_sequence(t_bank.empty_bank(tcfg, device="cpu"),
                                torch.as_tensor(frames_u8),
                                torch.as_tensor(d), torch.as_tensor(v), tcfg)
    # On the CPU every wrapper runs its plain version: nothing launches.
    assert (t_roi.launches, t_roi.launches_scales, t_auction.launches,
            t_kcfk.launches_detect, t_kcfk.launches_train) == counts
    assert to.valid.numpy().any()
    for f in range(frames.shape[0]):
        np.testing.assert_array_equal(to.ids[f].numpy(),
                                      np.asarray(jo.ids[f]), f"frame {f}")
        np.testing.assert_array_equal(to.valid[f].numpy(),
                                      np.asarray(jo.valid[f]), f"frame {f}")
        np.testing.assert_allclose(to.boxes[f].numpy(),
                                   np.asarray(jo.boxes[f]), rtol=0,
                                   atol=1e-3, err_msg=f"frame {f}")


def test_step_from_mid_sequence_heavy_jax_bank():
    frames, dets, jcfg, tcfg = _golden_heavy_inputs()
    d, v = _padded(dets, tcfg.max_detections)
    k = 10
    jb = j_bank.empty_bank(jcfg)
    for f in range(k):
        jb, _ = j_step.step(jb, jnp.asarray(frames[f]), jnp.asarray(d[f]),
                            jnp.asarray(v[f]), jcfg)
    tb = interop.bank_from_jax(jb)
    assert tuple(tb.kcf.xf.shape) == (32, 31, 16, 9)
    jb2, jo = j_step.step(jb, jnp.asarray(frames[k]), jnp.asarray(d[k]),
                          jnp.asarray(v[k]), jcfg)
    tb2, to = t_step.step(tb, torch.as_tensor(frames[k]),
                          torch.as_tensor(d[k]), torch.as_tensor(v[k]), tcfg)
    for name in ("ids", "valid", "matched_det", "n_alive", "n_births",
                 "n_deaths", "n_matches", "assign_iters"):
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)), name)
    np.testing.assert_allclose(to.boxes.numpy(), np.asarray(jo.boxes),
                               rtol=0, atol=1e-3)
    got = interop.bank_to_numpy(tb2)
    for part in ("xf", "alphaf"):
        cf = getattr(jb2.kcf, part)
        want = np.asarray(cf.re) + 1j * np.asarray(cf.im)
        have = got["kcf"][part][0] + 1j * got["kcf"][part][1]
        assert np.abs(have - want).max() <= 1e-3 * np.abs(want).max(), part
    # The same bank back into JAX: lossless.
    back = _jax_bank(interop.bank_to_numpy(tb))
    np.testing.assert_array_equal(np.asarray(back.kcf.xf.re),
                                  np.asarray(jb.kcf.xf.re))


def regen_bench_dump():
    """Run the JAX reference (tpu_mot on the CPU, roi_impl="pallas") over
    chip_smoke.py's bench fixture in H and HF; write ids, valid and boxes."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    frames_u8, d, v, *_, cfg = chip_smoke.bench_fixture()
    out = {}
    for name, extra in chip_smoke.HEAVY.items():
        jcfg, _ = both_configs(
            kcf=chip_smoke.HEAVY_KCF, max_tracks=cfg.max_tracks,
            max_detections=cfg.max_detections,
            frame_height=cfg.frame_height, frame_width=cfg.frame_width,
            roi_impl="pallas", **extra)
        _, o = j_scan.run_sequence(j_bank.empty_bank(jcfg),
                                   jnp.asarray(frames_u8), jnp.asarray(d),
                                   jnp.asarray(v), jcfg)
        key = name.lower()
        out[f"{key}_ids"] = np.asarray(o.ids, np.int32)
        out[f"{key}_valid"] = np.asarray(o.valid, bool)
        out[f"{key}_boxes"] = np.asarray(o.boxes, np.float32)
        print(f"{name}: {int(out[f'{key}_valid'].sum())} valid slot-frames")
    np.savez_compressed(chip_smoke.HEAVY_DUMP, **out)
    print(f"wrote {chip_smoke.HEAVY_DUMP}")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen-bench-dump"]:
        regen_bench_dump()
