"""The port's twins of the JAX package's last four measuring tools
(tpu_mot_torch/tools/bench_{multistream,class_cost,train_site,
template_size}.py) against the JAX tools on the CPU, at --small:

  (a) each twin's fixture equals one built with the JAX package's generator
      and pad_detections (6 columns for the class-aware row), and its rows
      are the JAX tool's (read from the tool's loops);
  (b) each row's warm-up run equals JAX's on the same inputs: ids, valid
      and the auction's rounds exact, boxes atol 1e-3 (as
      tests/test_torch_tracker.py), the last bank's alphaf within 1e-3 of
      the largest magnitude (as tests/test_torch_kcf_bank.py); against
      scan.run_sequence, and for bench_multistream against the JAX tool's
      form, a time-major scan of the step vmapped over the streams;
  (c) every line has the JAX tool's keys (read from its source) plus
      metric, spread_fps and device; scaling_vs_1 is a ratio; every stream
      of every S equals stream 0 of S = 1, which equals
      scan.run_sequence, bit for bit;
  (d) class-aware association with every detection of one class: whether
      it makes the class-blind run's decisions, answered on the CPU by
      JAX at --small and by the dump at full size;
  (e) bench_train_site's launches a frame (chip_smoke.TRAIN_SITE_LAUNCHES),
      counted through the kernels' wrappers on the CPU;
  (f) each twin raises without a card unless --device cpu is given, and an
      exception in a multistream row ends the run with a nonzero exit;
  (g) the committed dump holds every row at the full size, and each row
      but the class-aware one differs from the default row where its knob
      reaches the tracker.

The dump of the JAX reference on the full-size bench fixture, which
chip_smoke.py holds the card to, is regenerated by

    python tests/test_torch_sweeps.py regen-sweeps-dump
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import ast
import contextlib
import io
import json
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_config import both_configs
from test_torch_tools import _has_a_tool_key_set, _tool_ast
from tpu_mot.data import synthetic as j_synth
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import scan as j_scan
from tpu_mot.tracker import step as j_step
from tpu_mot.tracker.api import pad_detections as j_pad
from tpu_mot.utils import metrics as j_metrics
from tpu_mot_torch.kernels import auction as auction_k
from tpu_mot_torch.kernels import kcf as kcf_k
from tpu_mot_torch.kernels import roi as roi_k
from tpu_mot_torch.ops import kcf as kcf_ops
from tpu_mot_torch.tools import (bench, bench_class_cost, bench_multistream,
                                 bench_template_size, bench_train_site)
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import scan as t_scan

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = {"bench_multistream": bench_multistream,
         "bench_class_cost": bench_class_cost,
         "bench_train_site": bench_train_site,
         "bench_template_size": bench_template_size}
BOX_TOL = 1e-3          # px, the tracker against JAX (test_torch_tracker.py)
ALPHAF_TOL = 1e-3       # of the largest |alphaf| (test_torch_kcf_bank.py)
# every row of the four twins: (twin, the key of its warm-up run)
ROWS = ([("bench_multistream", s) for s in bench_multistream.STREAMS]
        + [("bench_class_cost", c) for c in bench_class_cost.ROWS]
        + [("bench_train_site", (c, s)) for c in bench_train_site.VARIANTS
           for s in bench_train_site.SITES]
        + [("bench_template_size", s) for s in bench_template_size.SIZES])


def _jax_fixture(n_frames, width=5):
    """bench.py's generator at --small through the JAX package: u8 frames,
    padded detections and valid."""
    sz = bench.SMALL
    h, w = sz["height"], sz["width"]
    rng = np.random.default_rng(0)
    objs = j_synth.make_objects(sz["n_obj"], h, w, rng, min_size=24,
                                max_size=64, max_speed=3.0)
    frames, boxes, vis = j_synth.render_sequence(objs, n_frames, h, w,
                                                 seed=0, noise=0.01)
    dets = j_synth.detections_from_gt(boxes, vis, seed=0, frame_hw=(h, w))
    padded = [j_pad(x, sz["max_dets"], width=width) for x in dets]
    return ((frames * 255).astype(np.uint8),
            np.stack([p[0] for p in padded]), np.stack([p[1] for p in padded]))


def _loop_values(name, target):
    """The values the JAX tool's `for <target> in (...)` loop takes."""
    for node in ast.walk(_tool_ast(name)):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
                and node.target.id == target):
            return [ast.literal_eval(e) for e in node.iter.elts]
    raise AssertionError(f"no loop over {target} in tools/{name}.py")


# -- (a) fixtures and rows ------------------------------------------------

@pytest.mark.parametrize("name", list(TWINS))
def test_fixture_matches_the_jax_tools(name):
    small = (bench_multistream.fixture(small=True)
             if name == "bench_multistream" else bench.fixture(small=True))
    frames, d, v = _jax_fixture(len(small.frames))
    np.testing.assert_array_equal(small.frames, frames)
    np.testing.assert_array_equal(small.dets, d)
    np.testing.assert_array_equal(small.valid, v)
    assert len(small.frames) == (bench_multistream.N_SMALL
                                 if name == "bench_multistream"
                                 else bench.SMALL["n_frames"])
    if name == "bench_class_cost":
        _, d6, v6 = _jax_fixture(len(small.frames), width=6)
        got = bench_class_cost.detections(small, True)
        np.testing.assert_array_equal(got[0], d6)
        np.testing.assert_array_equal(got[1], v6)
        assert got[0].shape[-1] == 6 and not got[0][..., 5].any()


def test_rows_are_the_jax_tools():
    assert list(bench_multistream.STREAMS) == _loop_values(
        "bench_multistream", "s_streams")
    assert list(bench_class_cost.ROWS) == _loop_values("bench_class_cost",
                                                       "class_aware")
    assert list(bench_train_site.SITES) == _loop_values("bench_train_site",
                                                        "site")
    assert list(bench_template_size.SIZES) == _loop_values(
        "bench_template_size", "s")
    names = [n for n in ast.walk(_tool_ast("bench_train_site"))
             if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) == "variants"][0]
    assert [e.elts[0].value for e in names.value.elts] == list(
        bench_train_site.VARIANTS)
    # the multistream clip's length: `n_obj, n_frames, reps = 128, 32, 5`
    sizes = [n for n in ast.walk(_tool_ast("bench_multistream"))
             if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Tuple)
             and [getattr(e, "id", None) for e in n.targets[0].elts][
                 :2] == ["n_obj", "n_frames"]][0]
    assert [e.value for e in sizes.value.elts][:2] == [
        bench.FULL["n_obj"], bench_multistream.N_FRAMES]


# -- (b) every row against JAX --------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """Each twin's main at --small with one sample: {name: (the printed
    lines, the returned lines, the warm-up runs, {row key: the bank its
    warm-up run left} for the twins on bench.warm_and_sample)}."""
    out = {}
    warm_and_sample = bench.warm_and_sample
    for name, twin in TWINS.items():
        banks = []

        def kept(*a, **kw):
            result = warm_and_sample(*a, **kw)
            banks.append(result[0])
            return result

        buf = io.StringIO()
        bench.warm_and_sample = kept
        try:
            with contextlib.redirect_stdout(buf):
                lines, outs = twin.main(["--device", "cpu", "--small",
                                         "--samples", "1"])
        finally:
            bench.warm_and_sample = warm_and_sample
        printed = [json.loads(x) for x in buf.getvalue().splitlines()]
        out[name] = (printed, lines, outs, dict(zip(outs, banks)))
    return out


def _row_config(name, key):
    """(TrackerConfig keyword arguments, detection width) of a row."""
    if name == "bench_class_cost":
        return dict(class_aware=key), 6 if key else 5
    if name == "bench_train_site":
        return dict(train_site=key[1],
                    kcf=bench_train_site.VARIANTS[key[0]]), 5
    if name == "bench_template_size":
        return dict(kcf=dict(template_size=key)), 5
    return {}, 5


_JAX_RUNS = {}


def _jax_run(n_frames, width, **kw):
    """JAX's scan.run_sequence over the --small fixture (cached by config)."""
    key = (n_frames, width, json.dumps(kw, sort_keys=True))
    if key not in _JAX_RUNS:
        frames, d, v = _jax_fixture(n_frames, width)
        sz = bench.SMALL
        jcfg, _ = both_configs(max_tracks=sz["max_tracks"],
                               max_detections=sz["max_dets"],
                               frame_height=sz["height"],
                               frame_width=sz["width"], **kw)
        b, o = j_scan.run_sequence(j_bank.empty_bank(jcfg),
                                   jnp.asarray(frames), jnp.asarray(d),
                                   jnp.asarray(v), jcfg)
        _JAX_RUNS[key] = {k: np.asarray(getattr(o, k))
                          for k in ("ids", "valid", "boxes", "assign_iters")}
        _JAX_RUNS[key]["alphaf"] = _jax_alphaf(b)
    return _JAX_RUNS[key]


def _jax_multistream(n_str):
    """The JAX tool's form (tools/bench_multistream.py:58-78): the step
    vmapped over S copies of the --small clip, scanned over time-major
    frames [N, S, H, W]; outputs [N, S, ...]."""
    frames, d, v = _jax_fixture(bench_multistream.N_SMALL)
    sz = bench.SMALL
    jcfg, _ = both_configs(max_tracks=sz["max_tracks"],
                           max_detections=sz["max_dets"],
                           frame_height=sz["height"],
                           frame_width=sz["width"])
    tm = [jnp.asarray(np.broadcast_to(x[:, None], (x.shape[0], n_str)
                                      + x.shape[1:]).copy())
          for x in (frames, d, v)]
    bank0 = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_str,) + x.shape).copy(),
        j_bank.empty_bank(jcfg))
    vstep = jax.vmap(lambda b, f, dd, vv: j_step.step(b, f, dd, vv, jcfg))

    def body(b, xs):
        b, out = vstep(b, *xs)
        return b, (out.ids, out.valid, out.boxes)

    _, (ids, valid, boxes) = jax.lax.scan(body, bank0, tuple(tm))
    return {"ids": np.asarray(ids), "valid": np.asarray(valid),
            "boxes": np.asarray(boxes)}


def _assert_tracks(ids, valid, boxes, want, what):
    np.testing.assert_array_equal(ids, want["ids"], err_msg=f"{what} ids")
    np.testing.assert_array_equal(valid, want["valid"],
                                  err_msg=f"{what} valid")
    np.testing.assert_allclose(boxes, want["boxes"], rtol=0, atol=BOX_TOL,
                               err_msg=f"{what} boxes")


@pytest.mark.parametrize("name,key", ROWS, ids=[f"{n}-{k}" for n, k in ROWS])
def test_row_matches_jax(runs, name, key):
    out = runs[name][2][key]
    assert out.valid.any()
    if name == "bench_multistream":
        want = _jax_multistream(key)
        for s in range(key):
            _assert_tracks(out.ids[s].numpy(), out.valid[s].numpy(),
                           out.boxes[s].numpy(),
                           {k: x[:, s] for k, x in want.items()},
                           f"S={key} stream {s}")
        return
    kw, width = _row_config(name, key)
    want = _jax_run(bench.SMALL["n_frames"], width, **kw)
    _assert_tracks(out.ids.numpy(), out.valid.numpy(), out.boxes.numpy(),
                   want, f"{name} {key}")
    np.testing.assert_array_equal(out.assign_iters.numpy(),
                                  want["assign_iters"])
    alphaf = runs[name][3][key].kcf.alphaf.numpy()
    assert alphaf.shape == want["alphaf"].shape
    assert (np.abs(alphaf - want["alphaf"]).max()
            <= ALPHAF_TOL * np.abs(want["alphaf"]).max())


# -- (c) the lines ---------------------------------------------------------

@pytest.mark.parametrize("name", list(TWINS))
def test_lines_have_the_jax_tools_keys(runs, name):
    printed, lines, outs, _ = runs[name]
    assert printed == lines and len(lines) == len(outs)
    for line in lines:
        _has_a_tool_key_set(name, line)
        assert {"metric", "spread_fps", "n_samples", "device"} <= set(line)
        assert line["device"] == "cpu" and line["n_samples"] == 1
        assert line["metric"].endswith("(cpu, --small)")
        rate = line.get("fps", line.get("aggregate_fps_per_chip"))
        assert rate > 0 and line["spread_fps"] == [rate, rate]


def test_scores_in_the_lines_are_jaxs(runs):
    """bench_train_site's clear_mot and bench_template_size's MOTA / HOTA
    equal utils/metrics of the JAX package on the JAX run's tracks."""
    fx = bench.fixture(small=True)
    gt = [(np.where(fx.visible[f])[0], fx.gt_boxes[f, fx.visible[f]])
          for f in range(len(fx.frames))]

    def jax_scores(**kw):
        run = _jax_run(bench.SMALL["n_frames"], 5, **kw)
        hyp = [(run["ids"][f, run["valid"][f]],
                run["boxes"][f, run["valid"][f]])
               for f in range(len(fx.frames))]
        return j_metrics.clear_mot(gt, hyp), j_metrics.hota(gt, hyp)

    for line in runs["bench_train_site"][1]:
        cm, _ = jax_scores(train_site=line["train_site"],
                           kcf=bench_train_site.VARIANTS[line["config"]])
        assert (line["mota_sanity"], line["idf1"], line["idsw"]) == (
            round(float(cm["mota"]), 4), round(float(cm["idf1"]), 4),
            int(cm["idsw"])), line
    for line in runs["bench_template_size"][1]:
        cm, h = jax_scores(kcf=dict(template_size=line["template_size"]))
        assert (line["mota"], line["hota"]) == (
            round(float(cm["mota"]), 4), round(float(h["hota"]), 4)), line


def test_scaling_vs_1_is_a_ratio(runs):
    lines = runs["bench_multistream"][1]
    assert [x["streams"] for x in lines] == list(bench_multistream.STREAMS)
    base = lines[0]["aggregate_fps_per_chip"]
    assert lines[0]["scaling_vs_1"] is None and "note" not in lines[0]
    for line in lines[1:]:
        ratio = line["aggregate_fps_per_chip"] / base
        # both rates are rounded to 0.1 frames/s
        assert abs(line["scaling_vs_1"] - ratio) <= 1e-3 + 0.1 * ratio / base
        assert line["scaling_vs_1"] != line["aggregate_fps_per_chip"]
        assert "scaling_vs_1" in line["note"]
        assert abs(line["ms_per_step"] * line["aggregate_fps_per_chip"]
                   - 1e3 * line["streams"]) <= 1e-2 * 1e3 * line["streams"]


def test_streams_equal_stream_0_of_one_stream(runs):
    """Every stream of every S equals stream 0 of S = 1 bit for bit, and
    that equals scan.run_sequence on the clip (chip_smoke.py's gate)."""
    outs = runs["bench_multistream"][2]
    fx = bench_multistream.fixture(small=True)
    cfg = fx.config()
    _, one = t_scan.run_sequence(t_bank.empty_bank(cfg, device="cpu"),
                                 *(torch.as_tensor(x) for x in (
                                     fx.frames, fx.dets, fx.valid)), cfg)
    for k in ("ids", "valid", "boxes"):
        assert torch.equal(getattr(outs[1], k)[0], getattr(one, k)), k
        for n_str, out in outs.items():
            for s in range(n_str):
                assert torch.equal(getattr(out, k)[s],
                                   getattr(one, k)), (n_str, s, k)


# -- (d) the class-cost question ------------------------------------------

def test_class_aware_decisions_against_class_blind(runs):
    """With every detection of class 0, does the class-aware run (gate +
    assoc_box "best") make the class-blind run's decisions?  JAX on the
    CPU at --small, the port's twin on the same inputs, and the dump at
    full size give the answer; chip_smoke holds the card to the full-size
    one."""
    n = bench.SMALL["n_frames"]
    blind, aware = _jax_run(n, 5), _jax_run(n, 6, class_aware=True)
    jax_same = bool(np.array_equal(blind["ids"], aware["ids"])
                    and np.array_equal(blind["valid"], aware["valid"]))
    outs = runs["bench_class_cost"][2]
    port_same = bool(torch.equal(outs[False].ids, outs[True].ids)
                     and torch.equal(outs[False].valid, outs[True].valid))
    assert port_same is jax_same
    assert [x["assoc_box_resolved"] for x in runs["bench_class_cost"][1]] \
        == ["refined", "best"]
    dump = np.load(chip_smoke.SWEEPS_DUMP)
    # the answer PERF.md states: the same decisions on every frame
    assert np.array_equal(dump["default_ids"], dump["class_aware_ids"])
    assert np.array_equal(dump["default_valid"], dump["class_aware_valid"])


# -- (e) launches a frame -------------------------------------------------

@pytest.mark.parametrize("row", list(chip_smoke.TRAIN_SITE_LAUNCHES),
                         ids=["-".join(r) for r in
                              chip_smoke.TRAIN_SITE_LAUNCHES])
def test_train_site_launches_a_frame(monkeypatch, row):
    """Each kernel wrapper's calls in a --small run of the row on the CPU
    through the kernel path (roi_impl="pallas"), over its frames.  K6 and
    K8 are chosen by the device, so their counts are of the calls whose
    input would take them on the card (`ops/kcf.train_shift_on_kernel` and
    `ops/kcf.search_on_kernel` with "cuda")."""
    calls = dict.fromkeys(chip_smoke.KERNELS, 0)
    for mod, attr, kernel in (
            (roi_k, "extract_patches", "roi_extract"),
            (roi_k, "extract_patches_scales", "roi_extract_scales"),
            (auction_k, "auction_solve", "auction_solve"),
            (kcf_k, "detect_fused", "kcf_detect"),
            (kcf_k, "train_fused", "kcf_train")):
        def counted(*a, _fn=getattr(mod, attr), _k=kernel, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    blend_auto = kcf_ops.train_shift_blend_auto

    def shift_counted(model, zf, dy, dx, yf, sigma, lambda_, lr, width,
                      impl="auto"):
        calls["kcf_train_shift"] += kcf_ops.train_shift_on_kernel(
            "cuda", zf.shape[-3], zf.shape[-2], width, impl)
        return blend_auto(model, zf, dy, dx, yf, sigma, lambda_, lr, width,
                          impl)
    monkeypatch.setattr(kcf_ops, "train_shift_blend_auto", shift_counted)
    search = kcf_ops.search

    def search_counted(model, feats, sigma, scale_wts, impl="auto"):
        calls["kcf_search"] += kcf_ops.search_on_kernel(
            "cuda", *feats.shape[2:], impl)
        return search(model, feats, sigma, scale_wts, impl)
    monkeypatch.setattr(kcf_ops, "search", search_counted)
    fx = bench.fixture(small=True)
    cfg = bench_train_site.config(fx, *row).replace(roi_impl="pallas")
    t_scan.run_sequence(t_bank.empty_bank(cfg, device="cpu"),
                        *(torch.as_tensor(x) for x in (
                            fx.frames, fx.dets, fx.valid)), cfg)
    n = len(fx.frames)
    want = dict.fromkeys(chip_smoke.KERNELS, 0)
    want.update(chip_smoke.TRAIN_SITE_LAUNCHES[row])
    assert calls == {k: n * c for k, c in want.items()}


def test_kernels_checked_holds_the_chosen_calls():
    """chip_smoke.kernels_checked(at) as the sweeps phase uses it: every
    call is counted at its shape, only the calls whose index is in `at`
    are held against the plain version (on the CPU the step calls the
    auction wrapper, K2's plain version there), and the run's outputs are
    the unchecked run's."""
    fx = bench.fixture(small=True)
    cfg = fx.config(roi_impl="pallas")
    args = [torch.as_tensor(x) for x in (fx.frames, fx.dets, fx.valid)]
    with chip_smoke.kernels_checked(at={0, 2, 5}) as st:
        _, out = t_scan.run_sequence(t_bank.empty_bank(cfg, device="cpu"),
                                     *args, cfg)
    n, k2 = len(fx.frames), (cfg.max_tracks, cfg.max_detections)
    assert st.calls == {("auction_solve", (1,) + k2): n}
    assert st.errs == {("auction_solve", (1,) + k2): [0, 0, 0]}
    assert st.by_kernel() == {"auction_solve": [0, 0, 0]}
    assert auction_k.auction_solve is chip_smoke.auction_k.auction_solve
    _, plain = t_scan.run_sequence(t_bank.empty_bank(cfg, device="cpu"),
                                   *args, cfg)
    for name in out._fields:
        assert torch.equal(getattr(out, name), getattr(plain, name))


def test_uncounted_leaves_the_launch_counts():
    counts = dict(zip(chip_smoke.KERNELS,
                      range(1, len(chip_smoke.KERNELS) + 1)))
    chip_smoke.set_counts(counts)
    with chip_smoke.uncounted():
        roi_k.launches += 3
        auction_k.launches += 8
        kcf_k.launches_train_shift += 2
    assert chip_smoke.read_counts() == counts
    chip_smoke.reset_counts()
    assert set(chip_smoke.read_counts().values()) == {0}


# -- (f) the card and failures ----------------------------------------------

@pytest.mark.parametrize("name", list(TWINS))
def test_twin_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TWINS[name].main([])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TWINS[name].main(["--small"])


def test_multistream_row_failure_exits_nonzero():
    """An exception in a row ends the run: a nonzero exit, the traceback on
    stderr, no "error" line (the JAX tool printed one and went on)."""
    code = (
        "import runpy, sys\n"
        "from tpu_mot_torch.parallel import serve\n"
        "def boom(*a, **k):\n"
        "    raise RuntimeError('row failed')\n"
        "serve.multi_stream_sequence = boom\n"
        "sys.argv = ['bench_multistream', '--device', 'cpu', '--small',\n"
        "            '--samples', '1']\n"
        "runpy.run_module('tpu_mot_torch.tools.bench_multistream',\n"
        "                 run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode != 0
    assert "row failed" in proc.stderr
    assert "error" not in proc.stdout


# -- (g) the dump ----------------------------------------------------------

@pytest.mark.parametrize("row", list(chip_smoke.SWEEP_ROWS))
def test_sweeps_dump_holds_every_row(row):
    """The committed JAX dump is the full fixture's: [64, 128] a row."""
    dump = np.load(chip_smoke.SWEEPS_DUMP)
    assert dump[f"{row}_ids"].shape == (64, 128)
    assert dump[f"{row}_valid"].shape == (64, 128)
    assert dump[f"{row}_boxes"].shape == (64, 128, 4)
    assert dump[f"{row}_valid"].any()
    assert 0.5 < float(dump[f"{row}_mota"]) <= 1.0
    assert 0.5 < float(dump[f"{row}_hota"]) <= 1.0
    assert dump[f"{row}_iters"].shape == (64,)
    s = chip_smoke.SWEEP_ROWS[row].get("kcf", {}).get("template_size", 64)
    if row == "fhog_refined":
        s = 64 // chip_smoke.HEAVY_KCF["cell_size"]
    assert dump[f"{row}_alphaf"].shape == (chip_smoke.SWEEP_BANK_SLOTS, s,
                                           s // 2 + 1)
    assert np.abs(dump[f"{row}_alphaf"]).max() > 0


@pytest.mark.parametrize("row", [r for r in chip_smoke.SWEEP_ROWS
                                 if r != "default"])
def test_dump_rows_against_the_default_row(row):
    """Where a row's knob reaches the tracker, the dump holds it apart from
    the default row's: the template size and the fHOG features in the
    last bank's alphaf shape, refined-site training in its values and in
    the auction's rounds.  Class-aware association with one class moves no
    output on this fixture: decisions, rounds and bank equal the default
    row's (PERF.md §2), so its gate checks those alone."""
    dump = np.load(chip_smoke.SWEEPS_DUMP)
    a, a0 = dump[f"{row}_alphaf"], dump["default_alphaf"]
    iters, iters0 = dump[f"{row}_iters"], dump["default_iters"]
    if row == "class_aware":
        assert np.array_equal(a, a0) and np.array_equal(iters, iters0)
    elif row == "gray_refined":
        assert np.abs(a - a0).max() > 10 * ALPHAF_TOL * np.abs(a0).max()
        assert not np.array_equal(iters, iters0)
    else:
        assert a.shape != a0.shape


def _jax_alphaf(jbank):
    """A JAX bank's KCF dual coefficients as complex64 [T, S, Sf]."""
    a = jbank.kcf.alphaf
    return (np.asarray(a.re) + 1j * np.asarray(a.im)).astype(np.complex64)


def regen_sweeps_dump():
    """Run the JAX reference (tpu_mot on the CPU, roi_impl="pallas") over
    bench.py's full-size fixture in every configuration of
    chip_smoke.SWEEP_ROWS; write each row's ids, valid and boxes (0 where
    not valid), the auction's rounds a frame, the alphaf of the last
    bank's first chip_smoke.SWEEP_BANK_SLOTS slots, and its MOTA and
    HOTA."""
    jax.config.update("jax_platforms", "cpu")
    fx = bench.fixture()
    gt = [(np.where(fx.visible[f])[0], fx.gt_boxes[f, fx.visible[f]])
          for f in range(len(fx.frames))]
    frames = jnp.asarray(fx.frames)
    out = {}
    for row, kw in chip_smoke.SWEEP_ROWS.items():
        d, v = bench_class_cost.detections(fx, kw.get("class_aware", False))
        cfg = fx.config()
        jcfg, _ = both_configs(max_tracks=cfg.max_tracks,
                               max_detections=cfg.max_detections,
                               frame_height=cfg.frame_height,
                               frame_width=cfg.frame_width,
                               roi_impl="pallas", **kw)
        b, o = j_scan.run_sequence(j_bank.empty_bank(jcfg), frames,
                                   jnp.asarray(d), jnp.asarray(v), jcfg)
        out[f"{row}_iters"] = np.asarray(o.assign_iters, np.int32)
        out[f"{row}_alphaf"] = _jax_alphaf(b)[:chip_smoke.SWEEP_BANK_SLOTS]
        ids, valid, boxes = (np.asarray(o.ids, np.int32),
                             np.asarray(o.valid, bool),
                             np.asarray(o.boxes, np.float32))
        hyp = [(ids[f, valid[f]], boxes[f, valid[f]])
               for f in range(len(ids))]
        out[f"{row}_ids"], out[f"{row}_valid"] = ids, valid
        out[f"{row}_boxes"] = np.where(valid[..., None], boxes, 0)
        out[f"{row}_mota"] = np.float64(j_metrics.clear_mot(gt, hyp)["mota"])
        out[f"{row}_hota"] = np.float64(j_metrics.hota(gt, hyp)["hota"])
        print(f"{row}: {int(valid.sum())} valid slot-frames, MOTA "
              f"{out[f'{row}_mota']}, HOTA {out[f'{row}_hota']}", flush=True)
    same = (np.array_equal(out["default_ids"], out["class_aware_ids"])
            and np.array_equal(out["default_valid"], out["class_aware_valid"]))
    print(f"class-aware decisions equal the class-blind run's: {same}")
    for row in chip_smoke.SWEEP_ROWS:
        a, a0 = out[f"{row}_alphaf"], out["default_alphaf"]
        moved = (a.shape != a0.shape
                 or float(np.abs(a - a0).max() / np.abs(a0).max()))
        print(f"{row}: auction rounds equal the default row's on "
              f"{int((out[f'{row}_iters'] == out['default_iters']).sum())} "
              f"frames; alphaf {a.shape}, off the default row's by {moved}")
    np.savez_compressed(chip_smoke.SWEEPS_DUMP, **out)
    print(f"wrote {chip_smoke.SWEEPS_DUMP}")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen-sweeps-dump"]:
        regen_sweeps_dump()
