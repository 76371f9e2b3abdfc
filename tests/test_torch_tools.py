"""The port's last five measuring entry points (tpu_mot_torch/tools/) against
the repo's JAX tools on the CPU, at small sizes:

  (a) bench_otb: the clip equals one rendered by the JAX package's
      generator; the gray rows' boxes equal JAX's run_otb_sequence frame by
      frame (atol 1e-2 px, as tests/test_torch_kcf_bank.py; the two runs
      sit 3e-5 px apart on the full clip), every row's line has
      tools/bench_otb.py's keys, and an fHOG-31 3-scale bank stepped from
      JAX's bank matches JAX's step (a free fHOG run drifts by pixels:
      its 4-px cells turn last-bit differences into other peaks);
  (b) bench_configs4: the frames equal the JAX tool's; dp equals shared
      (outputs and banks bit for bit), both equal S single streams through
      scan.run_sequence fed each stream's detections, stream 0 equals
      JAX's scan.run_sequence on those detections (ids, valid exact, boxes
      atol 1e-3 as tests/test_torch_tracker.py); the lines have the JAX
      tool's keys;
  (c) bench_ingest: the scenes and padded detections equal JAX's; the
      scheduler's bookkeeping holds (fresh + repeated = steps for every
      stream; pushed = fresh + dropped + left in the ring), every stream
      has live tracks at the end; the line has the JAX tool's keys;
  (d) bench_hard_fixture: the fixture equals the JAX tool's; the oracle
      tier equals the JAX tool's `_oracle` (loaded from the tool by path);
      every tracker tier's ids and valid equal JAX's scan.run_sequence
      (exact), and so do its scores; its boxes are held step by step from
      JAX's bank at 1e-2 px (the KCF bank's bound: a coasting slot's free
      run amplifies last-bit differences into pixels);
  (e) train_e2e_mota: the scenes and build_targets equal the JAX tool's;
      the cosine learning rate equals optax.cosine_decay_schedule at every
      step of a 10-step run; 3 Adam steps under it at batch 2, each from
      JAX's state before it, give JAX's losses within 1e-5 and optax's
      updates; det_f1 equals the JAX tool's
      on a seeded case; a tiny end-to-end run prints every phase;
  (f) each twin raises without a card unless --device cpu is given.

The JAX tools' keys are read from their sources (the dict literals they
pass to json.dumps).  The dump of the JAX reference on the full-size hard
fixture, which chip_smoke.py holds the card to, is regenerated by

    python tests/test_torch_tools.py regen-hard-dump
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import ast
import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from test_torch_config import both_configs
from tpu_mot import config as j_config
from tpu_mot.data import synthetic as j_synth
from tpu_mot.models import yolo as j_yolo
from tpu_mot.ops import patch as j_patch
from tpu_mot.parallel import train as j_train
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import kcf_bank as j_kb
from tpu_mot.tracker import scan as j_scan
from tpu_mot.tracker import step as j_step
from tpu_mot.tracker.api import pad_detections as j_pad
from tpu_mot.utils import metrics as j_metrics
from tpu_mot_torch import interop, native
from tpu_mot_torch.config import KCFConfig
from tpu_mot_torch.parallel import train as t_train
from tpu_mot_torch.tools import (bench_configs4, bench_hard_fixture,
                                 bench_ingest, bench_otb, train_e2e_mota)
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import kcf_bank as t_kb
from tpu_mot_torch.tracker import scan as t_scan
from tpu_mot_torch.tracker import step as t_step

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = {"bench_otb": bench_otb, "bench_configs4": bench_configs4,
         "bench_ingest": bench_ingest,
         "bench_hard_fixture": bench_hard_fixture,
         "train_e2e_mota": train_e2e_mota}
BOX_TOL = 1e-3          # px, the tracker against JAX (test_torch_tracker.py)
OTB_TOL = 1e-2          # px, a KCF bank against JAX (test_torch_kcf_bank.py)


def _tool(name):
    """The JAX tool tools/<name>.py as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_ast(name):
    with open(os.path.join(_REPO, "tools", f"{name}.py")) as fh:
        return ast.parse(fh.read())


def _keys(d):
    keys = set()
    for k, v in zip(d.keys, d.values):
        if isinstance(k, ast.Constant):
            keys.add(k.value)
            if k.value == "extra" and isinstance(v, ast.Dict):
                keys |= {f"extra.{kk.value}" for kk in v.keys}
    return keys


def _json_key_sets(name):
    """The key sets of the dicts the JAX tool passes to json.dumps: dict
    literals, or names bound to a dict literal."""
    tree = _tool_ast(name)
    bound = {node.targets[0].id: node.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and isinstance(node.targets[0], ast.Name)
             and isinstance(node.value, ast.Dict)}
    sets = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"
                and node.args):
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                arg = bound.get(arg.id)
            if isinstance(arg, ast.Dict):
                sets.append(_keys(arg))
    return sets


def _line_keys(line):
    return set(line) | {f"extra.{k}" for k in line.get("extra", {})}


def _has_a_tool_key_set(name, line):
    assert any(ks <= _line_keys(line) for ks in _json_key_sets(name)), (
        name, sorted(_line_keys(line)))


def _assert_tracks(got, want, what=""):
    for k in ("ids", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), want[k],
                                      err_msg=f"{what} {k}")
    np.testing.assert_allclose(got.boxes.numpy(), want["boxes"], rtol=0,
                               atol=BOX_TOL, err_msg=f"{what} boxes")


def jax_tier_run(fx, roi_impl="xla", **kw):
    """JAX's scan.run_sequence over a hard fixture in one tier."""
    cfg = fx.config(**kw)
    jcfg, _ = both_configs(max_tracks=cfg.max_tracks,
                           max_detections=cfg.max_detections,
                           frame_height=cfg.frame_height,
                           frame_width=cfg.frame_width, roi_impl=roi_impl,
                           **kw)
    return _jax_run(fx.frames, fx.dets, fx.valid, jcfg)


def _jax_run(frames, d, v, jcfg):
    _, o = j_scan.run_sequence(j_bank.empty_bank(jcfg), jnp.asarray(frames),
                               jnp.asarray(d), jnp.asarray(v), jcfg)
    return {k: np.asarray(getattr(o, k)) for k in ("ids", "valid", "boxes")}


# -- (a) bench_otb --------------------------------------------------------

@pytest.fixture(scope="module")
def otb_clip():
    return bench_otb.fixture()


def test_otb_clip_matches_jax(otb_clip):
    objs = [j_synth.SyntheticObject(**bench_otb.OBJECT)]
    frames, boxes, _ = j_synth.render_sequence(
        objs, bench_otb.N_FRAMES, bench_otb.HEIGHT, bench_otb.WIDTH,
        seed=bench_otb.SEED, noise=bench_otb.NOISE)
    np.testing.assert_array_equal(otb_clip.frames, frames)
    np.testing.assert_array_equal(otb_clip.boxes, boxes)
    assert frames.shape == (64, 480, 640)


@pytest.mark.parametrize("site", bench_otb.SITES)
def test_otb_gray_rows_match_jax_frame_by_frame(otb_clip, site):
    """The full clip, a free run in both packages: every frame's box within
    OTB_TOL (they sit 3e-5 px apart), the same centre errors."""
    frames = torch.as_tensor(otb_clip.frames)
    boxes, secs = bench_otb.run_row(frames, otb_clip, KCFConfig(), site, 1)
    fj = jnp.asarray(otb_clip.frames)
    cfg = j_config.KCFConfig()
    bank0 = j_kb.init_bank(j_patch.to_gray(fj[0]),
                           jnp.asarray(otb_clip.boxes[0, :1]),
                           jnp.ones((1,), bool), cfg)
    _, want, _ = j_kb.run_otb_sequence(bank0, fj[1:], cfg, train_site=site)
    want = np.asarray(want)
    assert boxes.shape == want.shape == (63, 1, 4) and len(secs) == 1
    for f in range(len(want)):
        np.testing.assert_allclose(boxes[f].numpy(), want[f], rtol=0,
                                   atol=OTB_TOL, err_msg=f"frame {f + 1}")
    err = bench_otb.center_err(boxes, otb_clip)
    want_err = np.hypot(want[:, 0, 0] - otb_clip.boxes[1:, 0, 0],
                        want[:, 0, 1] - otb_clip.boxes[1:, 0, 1])
    np.testing.assert_allclose(err, want_err, rtol=0, atol=OTB_TOL)
    assert err.max() < bench_otb.ENVELOPE_PX


def test_otb_fhog_3scale_steps_match_jax_from_its_bank(otb_clip):
    """fHOG-31 + 3 scales, refined site: 8 frames, each stepped in the
    port from JAX's bank (interop) against JAX's own step."""
    kw = bench_otb.VARIANTS["fhog-3scale"]
    jcfg, tcfg = j_config.KCFConfig(**kw), KCFConfig(**kw)
    fj = jnp.asarray(otb_clip.frames)
    jbank = j_kb.init_bank(j_patch.to_gray(fj[0]),
                           jnp.asarray(otb_clip.boxes[0, :1]),
                           jnp.ones((1,), bool), jcfg)
    for f in range(1, 9):
        tbank, _ = t_kb.step(interop.kcf_bank_from_jax(jbank, "cpu"),
                             torch.as_tensor(otb_clip.frames[f]), tcfg,
                             "refined")
        jbank, _ = j_kb.step(jbank, j_patch.to_gray(fj[f]), jcfg, "refined")
        np.testing.assert_allclose(tbank.boxes.numpy(),
                                   np.asarray(jbank.boxes), rtol=0,
                                   atol=OTB_TOL, err_msg=f"frame {f}")


def test_otb_main_prints_every_row(capsys):
    lines, outs = bench_otb.main(["--device", "cpu", "--small",
                                  "--samples", "1"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [(x["config"], x["train_site"]) for x in lines] == [
        (c, s) for c in bench_otb.VARIANTS for s in bench_otb.SITES]
    for line in lines:
        _has_a_tool_key_set("bench_otb", line)
        assert line["tracking_ok"] and line["fps"] > 0
        assert line["device"] == "cpu"
        assert line["metric"].endswith("(cpu, --small)")
    assert outs["gray", "refined"].shape == (bench_otb.N_SMALL - 1, 1, 4)


# -- (b) bench_configs4 ---------------------------------------------------

def test_configs4_fixture_matches_jax():
    sz = bench_configs4.SMALL
    fx = bench_configs4.fixture(small=True)
    rng = np.random.default_rng(0)
    objs = j_synth.make_objects(sz["n_obj"], sz["height"], sz["width"], rng,
                                min_size=24, max_size=64, max_speed=3.0)
    frames, _, _ = j_synth.render_sequence(objs, sz["n_frames"],
                                           sz["height"], sz["width"], seed=0,
                                           noise=0.01)
    u8 = (frames * 255).astype(np.uint8)
    want = np.stack([np.roll(u8, s * 7, axis=2)
                     for s in range(sz["n_streams"])], axis=1)
    np.testing.assert_array_equal(fx.frames, want)
    assert fx.frames.shape == (4, 2, 240, 320)


def test_configs4_rows_dp_shared_and_single_streams(capsys):
    lines, outs = bench_configs4.main(["--device", "cpu", "--small",
                                       "--samples", "1"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [x["mode"] for x in lines] == [*bench_configs4.MODES, "stages"]
    for line in lines:
        _has_a_tool_key_set("bench_configs4", line)
        assert line["device"] == "cpu"
    assert lines[1]["equal_to_dp"] is True
    assert all(line["aggregate_fps_per_chip"] > 0 for line in lines[:4])
    # one process: dp, shared and the tracker stage on the detector stage's
    # detections are the same run
    assert bench_configs4.same(outs["dp"], outs["shared"])
    assert bench_configs4.same(outs["dp"], outs["tracker"])
    fx = bench_configs4.fixture(small=True)
    cfg = fx.config()
    dets, valid, _ = outs["detector"]
    assert valid.any()
    jcfg, _ = both_configs(max_tracks=cfg.max_tracks,
                           max_detections=cfg.max_detections,
                           frame_height=cfg.frame_height,
                           frame_width=cfg.frame_width)
    for s in range(fx.frames.shape[1]):
        frames = torch.as_tensor(fx.frames[:, s])
        _, one = t_scan.run_sequence(t_bank.empty_bank(cfg, device="cpu"),
                                     frames, dets[s], valid[s], cfg)
        stream = type(one)(*[x[s] for x in outs["dp"]])
        assert bench_configs4.same(stream, one), s
        if s == 0:
            _assert_tracks(stream, _jax_run(fx.frames[:, 0], dets[0].numpy(),
                                            valid[0].numpy(), jcfg),
                           "stream 0 against JAX")
    assert outs["dp"].valid.any()


# -- (c) bench_ingest -----------------------------------------------------

def test_ingest_fixture_matches_jax():
    sz = bench_ingest.SMALL
    fx = bench_ingest.fixture(small=True)
    h, w = sz["height"], sz["width"]
    for sid in range(sz["n_streams"]):
        rng = np.random.default_rng(sid)
        objs = j_synth.make_objects(sz["n_obj"], h, w, rng, min_size=24,
                                    max_size=64, max_speed=3.0)
        frames, boxes, vis = j_synth.render_sequence(
            objs, sz["n_frames"], h, w, seed=sid, noise=0.01)
        dets = j_synth.detections_from_gt(boxes, vis, seed=sid,
                                          frame_hw=(h, w))
        np.testing.assert_array_equal(fx.frames[sid],
                                      (frames * 255).astype(np.uint8))
        for f in range(sz["n_frames"]):
            d, v = j_pad(dets[f], sz["max_dets"])
            np.testing.assert_array_equal(fx.dets[sid, f], d)
            np.testing.assert_array_equal(fx.valid[sid, f], v)


def test_ingest_line_keeps_the_schedulers_books(capsys):
    line, res = bench_ingest.main(["--device", "cpu", "--small"])
    assert json.loads(capsys.readouterr().out) == line
    keys = _json_key_sets("bench_ingest")[0] - {"extra.note"}
    assert keys <= _line_keys(line)
    ex = line["extra"]
    st = ex["sched_stats"]
    assert ex["scheduler"] == ("native" if native.ensure_built()
                               else "python")
    assert ex["steps"] > 0 and line["value"] > 0
    for s in range(ex["streams"]):
        assert st["fresh"][s] + st["repeated"][s] == ex["steps"], s
        assert ex["pushed"][s] == (st["fresh"][s] + st["dropped"][s]
                                   + ex["left_in_ring"][s]), s
        assert ex["pushed"][s] == bench_ingest.SMALL["n_frames"], s
        assert ex["alive_per_stream_at_end"][s] > 0, s
    assert ex["fresh_frames_tracked"] == sum(st["fresh"])
    assert ex["h2d_batch_ms_p50"] <= ex["h2d_batch_ms_p90"]


# -- (d) bench_hard_fixture -----------------------------------------------

@pytest.fixture(scope="module")
def hard_small():
    return bench_hard_fixture.fixture(small=True)


def test_hard_fixture_and_oracle_match_the_jax_tool(hard_small):
    sz = bench_hard_fixture.SMALL
    h, w, n_obj, n = (sz["height"], sz["width"], sz["n_obj"],
                      sz["n_frames"])
    rng = np.random.default_rng(0)
    objs = j_synth.make_objects(n_obj, h, w, rng, min_size=24, max_size=64,
                                max_speed=3.0)
    frames, boxes, vis = j_synth.render_sequence(objs, n, h, w, seed=0,
                                                 noise=0.01)
    dets = j_synth.detections_from_gt(boxes, vis, seed=0, jitter=2.0,
                                      drop_prob=0.25, fp_per_frame=4.0,
                                      frame_hw=(h, w))
    np.testing.assert_array_equal(hard_small.frames,
                                  (frames * 255).astype(np.uint8))
    assert hard_small.dets.shape[1] == n_obj + 40
    for f in range(n):
        np.testing.assert_array_equal(hard_small.dets_list[f], dets[f])
        d, v = j_pad(dets[f], n_obj + 40)
        np.testing.assert_array_equal(hard_small.dets[f], d)
        np.testing.assert_array_equal(hard_small.valid[f], v)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n)]
    want = _tool("bench_hard_fixture")._oracle(gt, dets)
    got = bench_hard_fixture.oracle(hard_small.gt, hard_small.dets_list)
    assert len(got) == len(want) == n
    for (gi, gb), (wi, wb) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gb, wb)
    assert sum(len(x[0]) for x in got) > 0


def _jax_scores(fx, run, tier):
    hyp = [(run["ids"][f, run["valid"][f]], run["boxes"][f, run["valid"][f]])
           for f in range(len(fx.frames))]
    h = j_metrics.hota(fx.gt, hyp)
    cm = j_metrics.clear_mot(fx.gt, hyp)
    return {"tier": tier, "hota": round(float(h["hota"]), 4),
            "deta": round(float(h["deta"]), 4),
            "assa": round(float(h["assa"]), 4),
            "loca": round(float(h["loca"]), 4),
            "mota": round(float(cm["mota"]), 4),
            "idf1": round(float(cm["idf1"]), 4), "idsw": int(cm["idsw"])}


@pytest.mark.parametrize("tier", list(bench_hard_fixture.TIERS))
def test_hard_fixture_tier_matches_jax(hard_small, tier):
    """The free run's ids and valid equal JAX's on every frame, and so do
    its scores; the boxes are held step by step from JAX's bank (interop)
    within OTB_TOL, the KCF bank's bound: a slot coasting on its KCF peak
    through dropped detections feeds its box back into its next window, so
    two free runs part by pixels on it (19.5 px by frame 23 here) while
    every single step agrees to 2.7e-3 px."""
    kw = bench_hard_fixture.TIERS[tier]
    [(_, _, out, secs)] = bench_hard_fixture.run(hard_small, {tier: kw}, 1,
                                                 "cpu")
    want = jax_tier_run(hard_small, **kw)
    for k in ("ids", "valid"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), want[k],
                                      err_msg=f"{tier} {k}")
    assert want["valid"].any() and len(secs) == 1
    cfg = hard_small.config(**kw)
    jcfg, _ = both_configs(max_tracks=cfg.max_tracks,
                           max_detections=cfg.max_detections,
                           frame_height=cfg.frame_height,
                           frame_width=cfg.frame_width, **kw)
    jb = j_bank.empty_bank(jcfg)
    for f, (fr, d, v) in enumerate(zip(hard_small.frames, hard_small.dets,
                                       hard_small.valid)):
        _, one = t_step.step(interop.bank_from_jax(jb, "cpu"),
                             torch.as_tensor(fr), torch.as_tensor(d),
                             torch.as_tensor(v), cfg)
        jb, jo = j_step.step(jb, jnp.asarray(fr), jnp.asarray(d),
                             jnp.asarray(v), jcfg)
        np.testing.assert_array_equal(one.ids.numpy(), np.asarray(jo.ids))
        np.testing.assert_allclose(one.boxes.numpy(), np.asarray(jo.boxes),
                                   rtol=0, atol=OTB_TOL,
                                   err_msg=f"{tier} frame {f}")
    line = bench_hard_fixture.tier_line(hard_small, tier, kw, out, secs,
                                        torch.device("cpu"))
    sc = _jax_scores(hard_small, want, tier)
    assert {k: line[k] for k in sc} == sc
    assert line["cfg"] == (str(kw) if kw else "defaults")


def test_hard_fixture_main_prints_every_tier(capsys):
    lines, outs = bench_hard_fixture.main(["--device", "cpu", "--small",
                                           "--samples", "1"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [x["tier"] for x in lines] == [bench_hard_fixture.ORACLE,
                                          *bench_hard_fixture.TIERS]
    tool_keys = _json_key_sets("bench_hard_fixture")[0]
    assert tool_keys <= set(lines[0])
    for line in lines[1:]:
        assert tool_keys | {"cfg", "fps", "device"} <= set(line)
        assert line["fps"] > 0 and line["device"] == "cpu"
    assert set(outs) == set(bench_hard_fixture.TIERS)


def test_hard_fixture_sweep_is_the_jax_tools(monkeypatch, capsys):
    """--sweep adds the JAX tool's n_init x max_age_tentative tiers (read
    from its loops), each a line."""
    loops = [n for n in ast.walk(_tool_ast("bench_hard_fixture"))
             if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple)]
    values = {n.target.id: [e.value for e in n.iter.elts] for n in loops}
    assert [kw for kw in bench_hard_fixture.SWEEP.values()] == [
        dict(n_init=a, max_age_tentative=b) for a in values["n_init"]
        for b in values["mat"]]
    seen = []
    monkeypatch.setattr(bench_hard_fixture, "run",
                        lambda fx, tiers, samples, dev: seen.append(
                            list(tiers)) or iter(()))
    lines, _ = bench_hard_fixture.main(["--device", "cpu", "--small",
                                        "--sweep"])
    assert seen == [[*bench_hard_fixture.TIERS, *bench_hard_fixture.SWEEP]]
    assert len(lines) == 1 and lines[0]["tier"] == bench_hard_fixture.ORACLE


# -- (e) train_e2e_mota ---------------------------------------------------

def _jax_spec(input_size, n_classes=1):
    return j_yolo.YoloSpec("yolov3-tiny", num_classes=n_classes,
                           stem="direct", input_size=input_size,
                           anchors=train_e2e_mota.ANCHORS, bn_momentum=0.9)


@pytest.mark.parametrize("n_classes", [1, 3])
def test_train_scenes_and_targets_match_the_jax_tool(n_classes):
    tool = _tool("train_e2e_mota")
    assert (tool.H, tool.W, tool.INPUT, tool.N_OBJ) == (
        train_e2e_mota.H, train_e2e_mota.W,
        train_e2e_mota.FULL["input_size"], train_e2e_mota.N_OBJ)
    got = train_e2e_mota.scenes(range(2), 3, n_classes)
    want = tool._scenes(range(2), 3, n_classes)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    boxes = np.concatenate([s[1] for s in got])
    vis = np.concatenate([s[2] for s in got])
    cls = np.concatenate([np.tile(s[3], (len(s[0]), 1)) for s in got])
    np.testing.assert_array_equal(train_e2e_mota.to_input_px(boxes, 256),
                                  tool._to_input_px(boxes))
    tsp = train_e2e_mota.spec_for(256, n_classes)
    t_tg = t_train.build_targets(
        tsp, train_e2e_mota.to_input_px(boxes, 256), cls, vis)
    j_tg = j_train.build_targets(_jax_spec(256, n_classes),
                                 tool._to_input_px(boxes), cls, vis)
    assert len(t_tg) == len(j_tg) == 2
    for a, b in zip(t_tg, j_tg):
        np.testing.assert_array_equal(a, np.asarray(b))


def _small_train_set(b=2, seed=0):
    sz = train_e2e_mota.SMALL
    images, targets = train_e2e_mota.train_set(sz, 1, "cpu")
    idx = np.random.default_rng(seed).integers(0, images.shape[0], (10, b))
    return images, targets, idx


def test_cosine_learning_rate_is_optax_at_every_step():
    """A 10-step run through `train`: the rate of every update equals
    optax.cosine_decay_schedule(1e-3, 10, 0.05) at that update's count."""
    images, targets, idx = _small_train_set()
    spec = train_e2e_mota.spec_for(train_e2e_mota.SMALL["input_size"])
    state = t_train.init_train_state(spec, train_e2e_mota.adam, seed=0,
                                     device="cpu")
    losses, lrs = train_e2e_mota.train(state, images, targets, spec, idx)
    sched = optax.cosine_decay_schedule(1e-3, 10, 0.05)
    want = [float(sched(t)) for t in range(10)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    assert [train_e2e_mota.cosine_lr(t, 10) for t in range(10)] == lrs
    assert losses.shape == (10,) and bool(torch.isfinite(losses).all())


def test_three_adam_steps_under_the_schedule_match_optax():
    """3 steps at batch 2 (input 128) of optax.adam(cosine_decay_schedule(
    1e-3, 3, 0.05)) in JAX, each taken again in the port from JAX's state
    before it (interop.yolo_train_state_from_jax: weights, statistics, Adam
    moments and count) at the twin's rate cosine_lr(i, 3): its loss within
    1e-5 of JAX's (relative; test_torch_train.py's bound for a step from
    one state), and its update of every parameter within 5% of the rate of
    optax's on all but 5% of the elements.  Adam moves an element by ~lr
    whatever its gradient's size, so one whose gradient float32 does not
    determine moves either way: at step 1 that is 1.73% of the elements
    (ConvBlock_3-6, the same under a constant rate: the gradients', not
    the optimizer's), at steps 0 and 2 under 1e-5; a free run therefore
    parts from JAX by 1e-3 of the loss at step 2.  A rate off the schedule
    moves every element 24-71% of lr away."""
    sz = dict(train_e2e_mota.SMALL, input_size=128)
    images, targets = train_e2e_mota.train_set(sz, 1, "cpu")
    idx = np.random.default_rng(0).integers(0, images.shape[0], (3, 2))
    tsp, jsp = train_e2e_mota.spec_for(128), _jax_spec(128)
    tree = interop.numpy_yolo_params(tsp, 2)
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, 3, 0.05))
    params = jax.tree.map(jnp.asarray, tree["params"])
    jstate = (params, jax.tree.map(jnp.asarray, tree["batch_stats"]),
              tx.init(params))
    jstep = j_train.make_train_step(jsp, tx)
    tstep = t_train.make_train_step(tsp)
    imgs = jnp.asarray(images.numpy())
    tgts = [jnp.asarray(t.numpy()) for t in targets]
    for i in range(3):
        before = jax.tree.map(np.asarray, jstate)
        sd, adam_state = interop.yolo_train_state_from_jax(*before)
        state = t_train.train_state_from_params(
            tsp, train_e2e_mota.adam, sd, adam_state if i else None,
            device="cpu")
        lr = train_e2e_mota.cosine_lr(i, 3)
        state.optimizer.param_groups[0]["lr"] = lr
        state, loss = tstep(state, images[idx[i]],
                            [t[idx[i]] for t in targets])
        jstate, jloss = jstep(jstate, imgs[idx[i]],
                              [t[idx[i]] for t in tgts])
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
        was = interop._param_leaves(before[0])
        now = interop._param_leaves(jax.tree.map(np.asarray, jstate[0]))
        n_off = n_all = 0
        for name, prm in state.model.named_parameters():
            moved = prm.detach().numpy() - was[name].numpy()
            want = now[name].numpy() - was[name].numpy()
            n_off += int((np.abs(moved - want) > 0.05 * lr).sum())
            n_all += moved.size
        assert n_off <= 0.05 * n_all, (i, n_off, n_all)


def test_det_f1_is_the_jax_tools():
    """The JAX tool's det_f1 (a closure inside its main, compiled here from
    its source over the same variables) on seeded detections."""
    tool = _tool("train_e2e_mota")
    fn = next(n for n in ast.walk(_tool_ast("train_e2e_mota"))
              if isinstance(n, ast.FunctionDef) and n.name == "det_f1")
    rng = np.random.default_rng(5)
    sc = train_e2e_mota.scenes((100,), 4)[0]
    vboxes, vvis = sc[1], sc[2]
    dets = np.zeros((4, 16, 5), np.float32)
    dets[:, :10, :4] = vboxes + rng.normal(0, 3, vboxes.shape)
    dets[:, 10:, :4] = rng.uniform(20, 200, (4, 6, 4))
    dets[..., 4] = rng.uniform(0, 1, (4, 16))
    valid = rng.random((4, 16)) < 0.9
    ns = {"np": np, "_iou": tool._iou, "vframes": np.zeros((4,)),
          "dets": dets, "valid": valid, "vboxes": vboxes, "vvis": vvis}
    exec(compile(ast.Module([fn], []), "det_f1", "exec"), ns)
    for thr in train_e2e_mota.THRESHOLDS:
        assert train_e2e_mota.det_f1(dets, valid, vboxes, vvis, thr) == \
            ns["det_f1"](thr), thr
    assert 0 < ns["det_f1"](0.1) < 1


def test_train_e2e_main_prints_every_phase(capsys, tmp_path):
    path = str(tmp_path / "params.npz")
    lines, res = train_e2e_mota.main(["--device", "cpu", "--small",
                                      "--save", path])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [x["phase"] for x in lines] == [
        "train", "map", "quant_map", "stem_map", "SUMMARY"]
    for line in lines:
        _has_a_tool_key_set("train_e2e_mota", line)
    assert lines[0]["steps"] == train_e2e_mota.SMALL["steps"]
    assert len(res["losses"]) == lines[0]["steps"]
    assert lines[-1]["device"] == "cpu"
    assert lines[-1]["metric"].endswith("(cpu, --small)")
    assert lines[1]["chosen_score_thr"] in train_e2e_mota.THRESHOLDS
    # --load restores the saved weights: the same detections, the same map
    again, res2 = train_e2e_mota.main(["--device", "cpu", "--small",
                                       "--load", path])
    assert again[0] == {"phase": "train", "loaded": path}
    assert again[1:] == lines[1:]
    for k, v in res["model"].state_dict().items():
        if not k.endswith("num_batches_tracked"):     # not in the JAX tree
            assert torch.equal(v, res2["model"].state_dict()[k]), k


# -- (f) the card ---------------------------------------------------------

@pytest.mark.parametrize("name", list(TWINS))
def test_twin_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TWINS[name].main([])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TWINS[name].main(["--small"])


def test_hard_dump_holds_the_three_tiers():
    """The committed JAX dump is the full fixture's: [64, 256] per tier."""
    dump = np.load(chip_smoke.HARD_DUMP)
    for i in range(len(bench_hard_fixture.TIERS)):
        assert dump[f"t{i}_ids"].shape == (64, 256)
        assert dump[f"t{i}_boxes"].shape == (64, 256, 4)
        assert dump[f"t{i}_valid"].any()
        assert 0.5 < float(dump[f"t{i}_mota"]) <= 1.0


def regen_hard_dump():
    """Run the JAX reference (tpu_mot on the CPU, roi_impl="pallas") over
    the full-size hard fixture in the three tracker tiers; write each
    tier's ids, valid and boxes, and its scores."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    fx = bench_hard_fixture.fixture()
    out = {}
    for i, (tier, kw) in enumerate(bench_hard_fixture.TIERS.items()):
        run = jax_tier_run(fx, "pallas", **kw)
        out[f"t{i}_ids"] = run["ids"].astype(np.int32)
        out[f"t{i}_valid"] = run["valid"].astype(bool)
        out[f"t{i}_boxes"] = np.where(run["valid"][..., None], run["boxes"],
                                      0).astype(np.float32)
        hyp = [(run["ids"][f, run["valid"][f]],
                run["boxes"][f, run["valid"][f]])
               for f in range(len(fx.frames))]
        sc = bench_hard_fixture.scores(fx.gt, hyp, tier)
        for key in ("hota", "mota"):
            out[f"t{i}_{key}"] = np.float64(sc[key])
        print(f"{tier}: {int(run['valid'].sum())} valid slot-frames, {sc}")
    np.savez_compressed(chip_smoke.HARD_DUMP, **out)
    print(f"wrote {chip_smoke.HARD_DUMP}")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen-hard-dump"]:
        regen_hard_dump()
