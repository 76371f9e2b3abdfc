"""The association branches of the port's step against the JAX tracker on
the CPU: the appearance blend, the class gate, assoc_box="best" and the
warm-started auction.

  (a) ops/iou.association_cost with each optional argument against the JAX
      function on seeded inputs (1e-6: the same float32 expressions);
  (b) tracker/step._sample_response against JAX's (1e-5 absolute: the same
      two hat-weight products, summed in another order), with a detection
      outside a track's window and one exactly on its border;
  (c) ops/assignment.auction_assign_warm against JAX's on a seeded sequence
      of perturbed problems with the carry passed along: row_to_col, iters,
      converged and col_of equal, prices within 1e-6 (sums and differences
      of the same float32 values); an empty carry equals the cold solve, a
      frame with permuted detections runs out the warm budget and resets,
      max_iters is hit, and N or M = 0;
  (d) the step under each branch alone and all together, frame by frame
      from the same bank through interop, on a small class fixture (16
      slots, 20 detections, 120 x 160, 12 frames): ids, valid, matched_det,
      cls and assign_iters equal, boxes within 1e-3 px (as the golden), the
      carried prices within 1e-5.

The bench-fixture dump of the JAX reference under the association
configurations A and AW, which chip_smoke.py holds the port to on the card,
is regenerated (and the reference's MOTA printed) by

    python tests/test_torch_assoc.py regen-bench-dump
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_config import both_configs
from tpu_mot.data import synthetic
from tpu_mot.ops import assignment as j_assign
from tpu_mot.ops import iou as j_iou
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import scan as j_scan
from tpu_mot.tracker import step as j_step
from tpu_mot_torch import interop
from tpu_mot_torch.kernels import auction as t_auction
from tpu_mot_torch.ops import assignment as t_assign
from tpu_mot_torch.ops import iou as t_iou
from tpu_mot_torch.tracker import api as t_api
from tpu_mot_torch.tracker import step as t_step

torch.set_num_threads(1)

T, D, H, W, N = 16, 20, 120, 160, 12


def _t(a):
    return torch.as_tensor(np.array(a))


# ---- (a) the cost ---------------------------------------------------------

def _cost_inputs(seed=0):
    rng = np.random.default_rng(seed)
    tracks = np.stack([rng.uniform(20, 140, T), rng.uniform(20, 100, T),
                       rng.uniform(8, 30, T), rng.uniform(8, 30, T)],
                      axis=1).astype(np.float32)
    dets = np.concatenate([
        tracks[:12] + rng.normal(0, 2, (12, 4)),
        np.stack([rng.uniform(20, 140, D - 12), rng.uniform(20, 100, D - 12),
                  rng.uniform(8, 30, D - 12), rng.uniform(8, 30, D - 12)],
                 axis=1)]).astype(np.float32)
    alt = (tracks + rng.normal(0, 3, tracks.shape)).astype(np.float32)
    return dict(
        tracks=tracks, dets=dets, alt=alt,
        t_valid=rng.random(T) < 0.8, d_valid=rng.random(D) < 0.9,
        # beyond [0, 1] on both sides: the clip matters
        appearance=rng.uniform(-0.3, 1.4, (T, D)).astype(np.float32),
        gate=rng.random((T, D)) < 0.7)


@pytest.mark.parametrize("case", ["plain", "appearance", "class_gate",
                                  "alt_boxes", "all"])
def test_association_cost_matches_jax(case):
    x = _cost_inputs()
    kw = {}
    if case in ("appearance", "all"):
        kw.update(appearance="appearance", appearance_weight=0.3)
    if case in ("class_gate", "all"):
        kw.update(class_gate="gate")
    if case in ("alt_boxes", "all"):
        kw.update(track_boxes_alt="alt")

    def call(fn, conv):
        return fn(conv(x["tracks"]), conv(x["dets"]), conv(x["t_valid"]),
                  conv(x["d_valid"]), 0.3, 1e4,
                  **{k: conv(x[v]) if isinstance(v, str) else v
                     for k, v in kw.items()})

    want = np.asarray(call(j_iou.association_cost, jnp.asarray))
    got = call(t_iou.association_cost, _t).numpy()
    assert (want < 1e3).any() and (want > 1e3).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if case != "plain":           # the argument changes the matrix
        plain = t_iou.association_cost(
            _t(x["tracks"]), _t(x["dets"]), _t(x["t_valid"]),
            _t(x["d_valid"]), 0.3, 1e4).numpy()
        assert not np.array_equal(got, plain)


def test_appearance_weight_zero_ignores_appearance():
    x = _cost_inputs(1)
    args = [_t(x[k]) for k in ("tracks", "dets", "t_valid", "d_valid")]
    assert torch.equal(
        t_iou.association_cost(*args, 0.3, 1e4,
                               appearance=_t(x["appearance"])),
        t_iou.association_cost(*args, 0.3, 1e4))


# ---- (b) the appearance sample -------------------------------------------

def test_sample_response_matches_jax():
    rng = np.random.default_rng(2)
    s = 16
    response = rng.standard_normal((T, s, s)).astype(np.float32)
    centers = np.stack([rng.uniform(30, 130, T), rng.uniform(30, 90, T)],
                       axis=1).astype(np.float32)
    win = rng.uniform(20, 60, (T, 2)).astype(np.float32)
    win[3] = 0.0                                  # floored at 1e-3
    dets = (centers[rng.integers(0, T, D)]
            + rng.normal(0, 6, (D, 2))).astype(np.float32)
    dets[0] = centers[0] + win[0]                 # outside track 0's window
    # Exactly on track 1's border: u = size - 1 in x, 0 in y (win 32 makes
    # the arithmetic exact in float32).
    win[1] = 32.0
    centers[1] = (64.0, 48.0)
    dets[1] = centers[1] + np.array([(s - 1 - s // 2) * 32.0 / s,
                                     -(s // 2) * 32.0 / s], np.float32)
    want = np.asarray(j_step._sample_response(
        jnp.asarray(response), jnp.asarray(centers), jnp.asarray(win),
        jnp.asarray(dets), s))
    # one stream: the port's detections carry a leading stream axis
    got = t_step._sample_response(_t(response), _t(centers), _t(win),
                                  _t(dets)[None], s)[0].numpy()
    assert got.shape == (T, D)
    assert got[0, 0] == 0.0 and want[0, 0] == 0.0
    assert got[1, 1] == response[1, 0, s - 1]     # the border pixel itself
    assert (want != 0).mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- (c) the warm auction --------------------------------------------------

def _problem(rng, n_rows, m_cols, base=None, jitter=0.0):
    """A MOT-like cost matrix: a noisy diagonal of cheap pairs over gated
    clutter; `base` perturbs a previous problem instead."""
    if base is None:
        cost = rng.uniform(0.5, 1.0, (n_rows, m_cols))
        k = min(n_rows, m_cols) - 3
        cost[np.arange(k), np.arange(k)] = rng.uniform(0.05, 0.3, k)
    else:
        cost = base + rng.normal(0, jitter, base.shape)
    cost = np.clip(cost, 0.0, 1.0).astype(np.float32)
    return cost, cost < 0.7


def _warm_both(cost, feas, prices, col_of, **kw):
    want = j_assign.auction_assign_warm(
        jnp.asarray(cost), jnp.asarray(feas), jnp.asarray(prices),
        jnp.asarray(col_of), **kw)
    got = t_assign.auction_assign_warm(_t(cost), _t(feas), _t(prices),
                                       _t(col_of), **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _assert_warm_equal(got, want, what=""):
    for k, name in enumerate(("row_to_col", "iters", "converged")):
        np.testing.assert_array_equal(got[k], want[k], f"{what} {name}")
    np.testing.assert_array_equal(got[4], want[4], f"{what} col_of")
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-6,
                               err_msg=f"{what} prices")
    assert got[0].dtype == np.int32 and got[4].dtype == np.int32
    assert got[3].dtype == np.float32


def test_warm_auction_sequence_matches_jax():
    """Ten perturbed frames with the carry passed along."""
    rng = np.random.default_rng(3)
    n = max(T, D)
    prices = np.zeros((n,), np.float32)
    col_of = np.full((n,), -1, np.int32)
    cost, feas = _problem(rng, T, D)
    iters = []
    for f in range(10):
        want, got = _warm_both(cost, feas, prices, col_of)
        _assert_warm_equal(got, want, f"frame {f}")
        assert want[2]
        iters.append(int(want[1]))
        prices, col_of = want[3], want[4]
        cost, feas = _problem(rng, T, D, base=cost, jitter=0.01)
    assert iters[0] >= 1 and min(iters[1:]) <= 2      # warm frames are short


def test_warm_auction_runs_out_its_budget_and_resets():
    """Four detections change places: most carried pairs still hold, the
    displaced rows fight over columns held at indifference, the warm budget
    (6 rounds) runs out and the solve restarts cold, its rounds added."""
    rng = np.random.default_rng(108)
    n = max(T, D)
    empty = (np.zeros((n,), np.float32), np.full((n,), -1, np.int32))
    cost, feas = _problem(rng, T, D)
    first, got = _warm_both(cost, feas, *empty)
    _assert_warm_equal(got, first, "first frame")
    idx = rng.choice(12, 4, replace=False)
    perm = np.arange(D)
    perm[idx] = np.roll(idx, 1)
    cost, feas = cost[:, perm], feas[:, perm]
    want, got = _warm_both(cost, feas, first[3], first[4])
    _assert_warm_equal(got, want, "permuted")
    cold = t_assign.auction_assign_warm(_t(cost), _t(feas),
                                        *map(_t, empty))
    assert int(want[1]) == 6 + int(cold[1]) and want[2]
    np.testing.assert_array_equal(got[0], cold[0].numpy())
    np.testing.assert_array_equal(got[4], cold[4].numpy())


@pytest.mark.parametrize("shape", [(T, D), (D, T), (7, 7)])
def test_warm_auction_empty_carry_is_the_cold_solve(shape):
    rng = np.random.default_rng(4)
    cost, feas = _problem(rng, *shape)
    n = max(shape)
    want, got = _warm_both(cost, feas, np.zeros((n,), np.float32),
                           np.full((n,), -1, np.int32))
    _assert_warm_equal(got, want)
    row, iters, conv = t_assign.auction_assign_stats(_t(cost), _t(feas),
                                                     impl="xla")
    np.testing.assert_array_equal(got[0], row.numpy())
    assert int(got[1]) == int(iters) and bool(got[2]) == bool(conv)
    # The square solution restricted to real pairs is the row result.
    b = t_assign.build_benefits(_t(cost), _t(feas), t_assign.DEFAULT_EPS)
    col, _ = t_auction.auction_solve_ref(b, t_assign.DEFAULT_EPS, 2000)
    np.testing.assert_array_equal(got[4], col.numpy())


def test_warm_auction_hits_max_iters():
    """Checks come every three rounds: a cap of 4 lets 6 rounds run and
    leaves a partial assignment, flagged."""
    rng = np.random.default_rng(5)
    cost = rng.uniform(0.0, 0.6, (D, D)).astype(np.float32)   # dense: slow
    feas = np.ones((D, D), bool)
    carry = (np.zeros((D,), np.float32), np.full((D,), -1, np.int32))
    full = t_assign.auction_assign_warm(_t(cost), _t(feas), *map(_t, carry))
    assert int(full[1]) > 8 and bool(full[2])
    want, got = _warm_both(cost, feas, *carry, max_iters=4)
    _assert_warm_equal(got, want)
    assert int(got[1]) == 6 and not got[2] and (got[4] < 0).any()


@pytest.mark.parametrize("shape", [(0, D), (T, 0)])
def test_warm_auction_empty_problem(shape):
    n = max(shape)
    prices = np.arange(n, dtype=np.float32)
    col_of = np.full((n,), -1, np.int32)
    want, got = _warm_both(np.zeros(shape, np.float32),
                           np.zeros(shape, bool), prices, col_of)
    _assert_warm_equal(got, want)
    assert got[0].shape == (shape[0],) and int(got[1]) == 0 and got[2]
    np.testing.assert_array_equal(got[3], prices)


def test_warm_auction_rejects_a_carry_of_the_wrong_size():
    cost, feas = _problem(np.random.default_rng(6), T, D)
    with pytest.raises(ValueError, match="squared problem"):
        t_assign.auction_assign_warm(_t(cost), _t(feas), torch.zeros(T),
                                     torch.full((T,), -1, dtype=torch.int32))


def test_warm_auction_counts_its_loop_checks():
    cost, feas = _problem(np.random.default_rng(7), T, D)
    n = max(T, D)
    before = t_assign.warm_checks
    out = t_assign.auction_assign_warm(
        _t(cost), _t(feas), torch.zeros(n),
        torch.full((n,), -1, dtype=torch.int32))
    cold_checks = t_assign.warm_checks - before
    assert cold_checks >= 3                # at least one body ran
    before = t_assign.warm_checks
    again = t_assign.auction_assign_warm(_t(cost), _t(feas), out[3], out[4])
    # The same problem from its own solution: every pair kept, no round.
    assert t_assign.warm_checks - before == 2 and int(again[1]) == 0
    assert torch.equal(again[0], out[0])


# ---- (d) the step ----------------------------------------------------------

def _class_fixture(seed=9):
    rng = np.random.default_rng(seed)
    objs = synthetic.make_objects(10, H, W, rng, min_size=12, max_size=24,
                                  max_speed=2.0, n_classes=3)
    frames, boxes, vis = synthetic.render_sequence(objs, N, H, W, seed=seed,
                                                   noise=0.01)
    dets = synthetic.detections_from_gt(
        boxes, vis, seed=seed, drop_prob=0.1, fp_per_frame=1.0,
        frame_hw=(H, W), classes=[o.cls for o in objs])
    d = np.zeros((N, D, 6), np.float32)
    v = np.zeros((N, D), bool)
    for f in range(N):
        d[f], v[f] = t_api.pad_detections(dets[f], D, width=6)
    return frames, d, v


BRANCHES = {
    "class_aware": dict(class_aware=True),
    "best": dict(assoc_box="best"),
    "appearance": dict(appearance_weight=0.3),
    "warm": dict(auction_warm_start=True),
    "all": dict(class_aware=True, assoc_box="best", appearance_weight=0.3,
                auction_warm_start=True),
    # refined-site training: no age != 1 zeroing of the appearance rows
    "appearance_refined": dict(appearance_weight=0.3, train_site="refined"),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_step_branch_matches_jax_frame_by_frame(branch):
    from test_torch_tracker import _jax_bank, jax_leaves

    frames, d, v = _class_fixture()
    jcfg, tcfg = both_configs(max_tracks=T, max_detections=D, frame_height=H,
                              frame_width=W, roi_impl="xla",
                              **BRANCHES[branch])
    jb = j_bank.empty_bank(jcfg)
    warm = tcfg.auction_warm_start
    seen_iters, seen_cls = [], set()
    for f in range(N):
        tb = interop.bank_from_jax(jb)
        jb, jo = j_step.step(jb, jnp.asarray(frames[f]), jnp.asarray(d[f]),
                             jnp.asarray(v[f]), jcfg)
        tb2, to = t_step.step(tb, _t(frames[f]), _t(d[f]), _t(v[f]), tcfg)
        for name in ("ids", "valid", "matched_det", "cls", "assign_iters",
                     "assign_converged", "n_births", "n_deaths"):
            np.testing.assert_array_equal(
                getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                f"frame {f} {name}")
        np.testing.assert_allclose(to.boxes.numpy(), np.asarray(jo.boxes),
                                   rtol=0, atol=1e-3,
                                   err_msg=f"frame {f} boxes")
        np.testing.assert_array_equal(tb2.auction_col_of.numpy(),
                                      np.asarray(jb.auction_col_of))
        np.testing.assert_allclose(tb2.auction_prices.numpy(),
                                   np.asarray(jb.auction_prices), rtol=0,
                                   atol=1e-5)
        seen_iters.append(int(to.assign_iters))
        seen_cls |= set(to.cls.numpy()[to.valid.numpy()].tolist())
    assert to.valid.numpy().sum() >= 5
    assert seen_cls == {0, 1, 2}
    carried = np.asarray(jb.auction_col_of)
    assert (carried >= 0).all() if warm else (carried == -1).all()
    if warm:
        # A warm bank crosses interop in both directions unchanged.
        back = _jax_bank(interop.bank_to_numpy(interop.bank_from_jax(jb)))
        for a, b in zip(jax_leaves(back), jax_leaves(jb)):
            np.testing.assert_array_equal(a, b)
        assert np.abs(np.asarray(jb.auction_prices)).max() > 0
        assert max(seen_iters) >= 1


def test_warm_start_falls_back_to_cold_on_another_detection_padding():
    """The carry is sized for cfg.max_detections; a caller that pads to
    another width gets the cold solve and the carry passes through."""
    frames, d, v = _class_fixture()
    _, tcfg = both_configs(max_tracks=T, max_detections=D, frame_height=H,
                           frame_width=W, roi_impl="xla",
                           auction_warm_start=True)
    from tpu_mot_torch.tracker import bank as t_bank
    bank = t_bank.empty_bank(tcfg, device="cpu")
    wide = np.zeros((D + 4, 6), np.float32)
    wide[:D] = d[0]
    valid = np.concatenate([v[0], np.zeros(4, bool)])
    before = t_assign.warm_checks
    new, out = t_step.step(bank, _t(frames[0]), _t(wide), _t(valid), tcfg)
    assert t_assign.warm_checks == before
    assert torch.equal(new.auction_prices, bank.auction_prices)
    assert int(out.n_births) == int(v[0].sum())


def test_class_aware_tracks_keep_their_detections_class():
    """Under the class gate a valid track's class is its matched
    detection's."""
    frames, d, v = _class_fixture()
    _, tcfg = both_configs(max_tracks=T, max_detections=D, frame_height=H,
                           frame_width=W, roi_impl="xla",
                           **chip_smoke.ASSOC_BASE)
    assert tcfg.assoc_box_resolved == "best"
    from tpu_mot_torch.tracker import bank as t_bank
    from tpu_mot_torch.tracker import scan as t_scan
    _, out = t_scan.run_sequence(t_bank.empty_bank(tcfg, device="cpu"),
                                 _t(frames), _t(d), _t(v), tcfg)
    assert chip_smoke.class_mismatches(out, _t(d)) == 0
    assert int((out.valid & (out.matched_det >= 0)).sum()) > 50


# ---- the JAX reference on the bench class fixture -------------------------

def regen_bench_dump():
    """Run the JAX reference (tpu_mot on the CPU, roi_impl="pallas") over
    chip_smoke.py's class fixture under A and AW; write ids, valid, boxes
    and cls, print MOTA (chip_smoke.ASSOC_M_REF)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    frames_u8, d, v, gt_boxes, vis, _, cfg = chip_smoke.assoc_fixture()
    out = {}
    for name, extra in chip_smoke.ASSOC.items():
        jcfg, _ = both_configs(
            max_tracks=cfg.max_tracks, max_detections=cfg.max_detections,
            frame_height=cfg.frame_height, frame_width=cfg.frame_width,
            roi_impl="pallas", **chip_smoke.ASSOC_BASE, **extra)
        _, o = j_scan.run_sequence(j_bank.empty_bank(jcfg),
                                   jnp.asarray(frames_u8), jnp.asarray(d),
                                   jnp.asarray(v), jcfg)
        key = name.lower()
        out[f"{key}_ids"] = np.array(o.ids, np.int32)
        out[f"{key}_valid"] = np.array(o.valid, bool)
        out[f"{key}_boxes"] = np.array(o.boxes, np.float32)
        out[f"{key}_cls"] = np.array(o.cls, np.int32)
        out[f"{key}_iters"] = np.array(o.assign_iters, np.int32)
        as_torch = types.SimpleNamespace(
            ids=torch.as_tensor(out[f"{key}_ids"]),
            valid=torch.as_tensor(out[f"{key}_valid"]),
            boxes=torch.as_tensor(out[f"{key}_boxes"]))
        _, mota, h_all = chip_smoke.score(as_torch, gt_boxes, vis)
        it = out[f"{key}_iters"]
        print(f"{name}: MOTA {mota!r}, HOTA {h_all['hota']!r}; "
              f"{int(out[f'{key}_valid'].sum())} valid slot-frames; auction "
              f"rounds median {np.median(it)}, max {it.max()}")
    np.savez_compressed(chip_smoke.ASSOC_DUMP, **out)
    print(f"wrote {chip_smoke.ASSOC_DUMP}")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen-bench-dump"]:
        regen_bench_dump()
