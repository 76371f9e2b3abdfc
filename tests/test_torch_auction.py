"""Auction solve of the port (tpu_mot_torch.kernels.auction) against the
Pallas auction kernel run in interpret mode on the CPU, and the assignment
wrapper against scipy.

The auction has no multiply anywhere (bids are sums and differences), so
the plain version must reproduce the Pallas kernel EXACTLY: col_of and
iters equal, not merely equal cost.  The CUDA kernel itself is tested
on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mot.kernels import auction as j_auction
from tpu_mot.ops import assignment as j_assign
from tpu_mot.ops import iou as j_iou
from tpu_mot_torch.kernels import _build
from tpu_mot_torch.kernels import auction as t_auction
from tpu_mot_torch.ops import assignment as t_assign

# The tensors here are small: torch's intra-op thread pool would only
# oversubscribe the cores that the JAX side and the other test workers use.
torch.set_num_threads(1)

EPS = t_assign.DEFAULT_EPS


def _mot_problem(rng, n_trk, n_det, n_match):
    """MOT-shaped gated cost: jittered matches plus clutter and padding."""
    tracks = rng.uniform(50, 1800, (n_trk, 4)).astype(np.float32)
    tracks[:, 1] = rng.uniform(50, 1000, n_trk)
    tracks[:, 2:] = rng.uniform(24, 64, (n_trk, 2))
    dets = np.concatenate([
        tracks[:n_match] + rng.normal(0, 3, (n_match, 4)),
        rng.uniform(50, 1000, (n_det - n_match, 4))]).astype(np.float32)
    dvalid = np.ones((n_det,), bool)
    dvalid[-10:] = False                                 # padding slots
    cost = np.asarray(j_iou.association_cost(
        jnp.asarray(tracks), jnp.asarray(dets), jnp.ones((n_trk,), bool),
        jnp.asarray(dvalid), iou_gate=0.1, infeasible=1e4)).astype(np.float32)
    return cost, cost < 1e3


def _random_problem(rng, n, m, p_feasible=0.8):
    return (rng.uniform(0, 1, (n, m)).astype(np.float32),
            rng.random((n, m)) < p_feasible)


def _benefits(cost, feasible):
    return np.array(j_assign.build_benefits(jnp.asarray(cost),
                                            jnp.asarray(feasible), EPS))


@pytest.mark.parametrize("case", ["n8", "n40", "n160", "mot128x160",
                                  "rect16x11", "rect5x20", "all_infeasible",
                                  "dead_rows"])
def test_plain_solve_matches_pallas_interpret_exactly(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("n"):
        n = int(case[1:])
        cost, feas = _random_problem(rng, n, n)
    elif case == "mot128x160":
        cost, feas = _mot_problem(rng, 128, 160, 100)
    elif case.startswith("rect"):
        n, m = map(int, case[4:].split("x"))
        cost, feas = _random_problem(rng, n, m)
    elif case == "all_infeasible":
        cost, feas = np.ones((6, 4), np.float32), np.zeros((6, 4), bool)
    else:
        cost, feas = _random_problem(rng, 12, 9, 0.5)
        feas[[0, 3, 4, 11]] = False
    b = _benefits(cost, feas)
    np.testing.assert_array_equal(
        t_assign.build_benefits(torch.as_tensor(cost), torch.as_tensor(feas),
                                EPS).numpy(), b)
    want_col, want_it = j_auction.auction_solve_pallas(
        jnp.asarray(b), EPS, 2000, interpret=True)
    col, it = t_auction.auction_solve_ref(torch.as_tensor(b), EPS, 2000)
    np.testing.assert_array_equal(col.numpy(), np.asarray(want_col))
    assert int(it) == int(want_it)
    assert (col.numpy() >= 0).all()


@pytest.mark.parametrize("max_iters", [1, 3])
def test_capped_solve_matches_pallas_interpret(max_iters):
    """The capped contract: partial col_of (-1 rows) and iters equal to the
    kernel's; the wrapper reports converged=False and well-formed rows."""
    rng = np.random.default_rng(11)
    cost = rng.uniform(0.0, 2.0, (24, 30)).astype(np.float32)
    feas = rng.random((24, 30)) < 0.6
    cost = np.where(feas, cost, 1e4).astype(np.float32)
    b = _benefits(cost, feas)
    want_col, want_it = j_auction.auction_solve_pallas(
        jnp.asarray(b), EPS, max_iters, interpret=True)
    col, it = t_auction.auction_solve_ref(torch.as_tensor(b), EPS, max_iters)
    np.testing.assert_array_equal(col.numpy(), np.asarray(want_col))
    assert int(it) == int(want_it) == max_iters
    got, iters, conv = t_assign.auction_assign_stats(
        torch.as_tensor(cost), torch.as_tensor(feas), max_iters=max_iters)
    got = got.numpy()
    assert not bool(conv) and int(iters) == max_iters
    matched = got[got >= 0]
    assert (matched < 30).all() and len(np.unique(matched)) == len(matched)
    rows = np.where(got >= 0)[0]
    assert feas[rows, got[rows]].all()


def test_assign_stats_matches_jax_pallas_path_and_scipy_cost():
    """At the bench shape (128 x 160): the port's assignment equals the JAX
    Pallas path's and its cost equals scipy's (gated MOT instances solve
    exactly; one eps of slack for tie reshuffles, as the JAX test)."""
    rng = np.random.default_rng(0)
    for _ in range(2):
        cost, feas = _mot_problem(rng, 128, 160, 110)
        got, iters, conv = t_assign.auction_assign_stats(
            torch.as_tensor(cost), torch.as_tensor(feas))
        want, want_it, want_conv = j_assign.auction_assign_stats(
            jnp.asarray(cost), jnp.asarray(feas), impl="pallas")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(iters) == int(want_it) and bool(conv) == bool(want_conv)
        ref = t_assign.scipy_assign(cost, feas)
        assert (got.numpy() >= 0).sum() == (ref >= 0).sum()
        assert (j_assign.assignment_cost(cost, got.numpy())
                <= j_assign.assignment_cost(cost, ref) + EPS)


def test_empty_problem_and_xla_impl():
    col, it, conv = t_assign.auction_assign_stats(
        torch.zeros((0, 5)), torch.zeros((0, 5), dtype=torch.bool))
    assert col.shape == (0,) and int(it) == 0 and bool(conv)
    rng = np.random.default_rng(5)
    cost, feas = _random_problem(rng, 7, 9)
    a = t_assign.auction_assign_stats(torch.as_tensor(cost),
                                      torch.as_tensor(feas), impl="xla")
    b = t_assign.auction_assign_stats(torch.as_tensor(cost),
                                      torch.as_tensor(feas), impl="pallas")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(6)
    b = torch.as_tensor(_benefits(*_random_problem(rng, 10, 10)))
    before = t_auction.launches
    got = t_auction.auction_solve(b, EPS, 2000)
    want = t_auction.auction_solve_ref(b, EPS, 2000)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert t_auction.launches == before


def test_build_raises_clearly_without_nvcc(tmp_path, monkeypatch):
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()


# ---- what the CUDA kernel's schedule relies on, mirrored in plain torch --

def test_bid_key_maximum_is_highest_bid_then_lowest_row():
    """The kernel scatters bids with an atomicMax on (ordered float bits,
    0xFFFFFFFF - row): the largest key must be the highest bid and, among
    equal bids, the lowest row, for random, equal, tiny and huge bids."""
    rng = np.random.default_rng(3)
    tiny = np.float32(1e-45)                     # smallest subnormal
    sets = [rng.uniform(0.02, 6.0, 64), np.full(17, 1.25),
            [tiny, 2 * tiny, 1e-38, 1.1754944e-38, 0.02],
            [1e30, 1e30, 3.0e38, 1e30, 3.0e38],
            rng.choice([0.02, 0.27, 0.52, 5.0], 200),
            [0.0, -0.0, -1.5, -1e30, 0.02]]
    for bids in sets:
        bid = torch.as_tensor(np.asarray(bids, np.float32))
        rows = torch.as_tensor(rng.permutation(len(bid)) * 3)
        keys = t_auction.bid_keys(bid, rows)
        top = int(torch.argmax(keys))
        best = bid.max()
        assert bid[top] == best
        assert rows[top] == rows[bid == best].min()
        got_bid, got_row = t_auction.split_keys(keys)
        assert torch.equal(got_bid.view(torch.int32), bid.view(torch.int32))
        assert torch.equal(got_row, rows)
        # float order is kept between every pair, not only at the top
        order = torch.argsort(keys >> 32, stable=True)
        assert bool((bid[order][1:] >= bid[order][:-1]).all())
    assert int(t_auction.bid_keys(torch.tensor([-3.0e38]),
                                  torch.tensor([0])) >> 32) > -2 ** 31


def _quantised(rng, n, m):
    """Costs on a grid and benefits rounded to it (no jitter): many rows
    place equal bids on one column."""
    cost = (np.round(rng.uniform(0, 1, (n, m)) * 4) / 4).astype(np.float32)
    b = _benefits(cost, rng.random((n, m)) < 0.8)
    return (np.round(b * 4) / 4).astype(np.float32)


@pytest.mark.parametrize("case", ["n8", "n40", "n160", "mot128x160",
                                  "rect16x11", "all_infeasible", "dead_rows",
                                  "ties7", "ties40", "ties159", "n1", "n33"])
@pytest.mark.parametrize("max_iters", [2000, 3])
def test_scatter_round_matches_plain_and_pallas_exactly(case, max_iters):
    """The kernel's round (winner by key, one merged apply step, an
    unassigned count for the exit test) against the dense plain version and
    the interpret-mode Pallas kernel: col_of and iters equal, capped or
    not."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("ties"):
        b = _quantised(rng, int(case[4:]), int(case[4:]))
    elif case.startswith("n"):
        b = _benefits(*_random_problem(rng, int(case[1:]), int(case[1:])))
    elif case == "mot128x160":
        b = _benefits(*_mot_problem(rng, 128, 160, 100))
    elif case.startswith("rect"):
        n, m = map(int, case[4:].split("x"))
        b = _benefits(*_random_problem(rng, n, m))
    elif case == "all_infeasible":
        b = _benefits(np.ones((6, 4), np.float32), np.zeros((6, 4), bool))
    else:
        cost, feas = _random_problem(rng, 12, 9, 0.5)
        feas[[0, 3, 4, 11]] = False
        b = _benefits(cost, feas)
    col, it = t_auction.auction_solve_scatter_ref(torch.as_tensor(b), EPS,
                                                  max_iters)
    want_col, want_it = t_auction.auction_solve_ref(torch.as_tensor(b), EPS,
                                                    max_iters)
    assert torch.equal(col, want_col) and int(it) == int(want_it)
    jax_col, jax_it = j_auction.auction_solve_pallas(
        jnp.asarray(b), EPS, max_iters, interpret=True)
    np.testing.assert_array_equal(col.numpy(), np.asarray(jax_col))
    assert int(it) == int(jax_it)


# ---- serving: a batch of problems [S, n, n] --------------------------------

@pytest.mark.parametrize("case", ["n5x3", "mot128x4", "capped", "n33x2"])
def test_batched_solve_equals_single_solves(case):
    """Each problem of a batch gets the single solve's col_of and iters,
    also when one problem runs into max_iters while the others finish
    early (a finished problem's count stops), in the plain version, the
    kernel's schedule and the CPU wrapper; the JAX Pallas kernel under vmap
    agrees."""
    rng = np.random.default_rng(len(case))
    max_iters = 2000
    if case == "n5x3":
        bs = [_benefits(*_random_problem(rng, 5, 5)) for _ in range(3)]
    elif case == "mot128x4":
        bs = [_benefits(*_mot_problem(rng, 128, 128, 100)) for _ in range(4)]
    elif case == "capped":
        # quantised benefits need many rounds; a clear diagonal needs one
        tie = np.round(_benefits(*_random_problem(rng, 40, 40)) * 4) / 4
        easy = _benefits((0.9 - 0.8 * np.eye(40)).astype(np.float32),
                         np.ones((40, 40), bool))
        bs = [easy, tie, easy[::-1].copy()]
        max_iters = int(t_auction.auction_solve_ref(
            torch.as_tensor(tie), EPS, 2000)[1]) - 1
    else:
        bs = [_benefits(*_random_problem(rng, 33, 33)) for _ in range(2)]
    b = torch.as_tensor(np.stack(bs).astype(np.float32))
    col, it = t_auction.auction_solve_ref(b, EPS, max_iters)
    assert col.shape == b.shape[:2] and it.shape == b.shape[:1]
    for p in range(b.shape[0]):
        c1, i1 = t_auction.auction_solve_ref(b[p], EPS, max_iters)
        assert torch.equal(col[p], c1) and int(it[p]) == int(i1)
    s_col, s_it = t_auction.auction_solve_scatter_ref(b, EPS, max_iters)
    assert torch.equal(s_col, col) and torch.equal(s_it, it)
    w_col, w_it = t_auction.auction_solve(b, EPS, max_iters)
    assert torch.equal(w_col, col) and torch.equal(w_it, it)
    import jax
    j_col, j_it = jax.vmap(lambda x: j_auction.auction_solve_pallas(
        x, EPS, max_iters, interpret=True))(jnp.asarray(b.numpy()))
    np.testing.assert_array_equal(col.numpy(), np.asarray(j_col))
    np.testing.assert_array_equal(it.numpy(), np.asarray(j_it))
    if case == "capped":
        assert int(it[1]) == max_iters and (col[1] < 0).any()
        assert int(it[0]) < max_iters and (col[0] >= 0).all()


def test_batched_assignment_and_warm_auction_equal_single_problems():
    """auction_assign_stats and auction_assign_warm on [S, N, M] (the carry
    [S, n]) give each problem an unbatched call's outputs, carried prices
    and matching included."""
    rng = np.random.default_rng(11)
    probs = [_mot_problem(rng, 24, 30, 18) for _ in range(3)]
    cost = torch.as_tensor(np.stack([p[0] for p in probs]))
    feas = torch.as_tensor(np.stack([p[1] for p in probs]))
    got = t_assign.auction_assign_stats(cost, feas)
    assert got[0].shape == (3, 24) and got[1].shape == (3,)
    for p in range(3):
        one = t_assign.auction_assign_stats(cost[p], feas[p])
        assert all(torch.equal(x[p], y) for x, y in zip(got, one))
    prices = torch.zeros((3, 30))
    col_of = torch.full((3, 30), -1, dtype=torch.int32)
    for step in range(3):       # the carry grows warm over three calls
        c = cost + torch.as_tensor(rng.normal(0, 0.02, cost.shape).astype(
            np.float32)) * step
        warm = t_assign.auction_assign_warm(c, feas, prices, col_of)
        for p in range(3):
            one = t_assign.auction_assign_warm(c[p], feas[p], prices[p],
                                               col_of[p])
            assert all(torch.equal(x[p], y) for x, y in zip(warm, one))
        prices, col_of = warm[3], warm[4]


def test_auction_assign_and_assignment_cost_match_jax():
    rng = np.random.default_rng(12)
    for n, m in ((16, 11), (40, 40)):
        cost, feas = _random_problem(rng, n, m)
        got = t_assign.auction_assign(torch.as_tensor(cost),
                                      torch.as_tensor(feas))
        want = j_assign.auction_assign(jnp.asarray(cost), jnp.asarray(feas))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (t_assign.assignment_cost(cost, got.numpy())
                == j_assign.assignment_cost(cost, np.asarray(want)))


def _contested(seed, n=12):
    """Every row wants column 0 most, then the rest in seeded order: each
    round settles one conflict, so small caps stop mid-solve."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0.5, 1.0, (n, n)).astype(np.float32)
    cost[:, 0] = rng.uniform(0.0, 0.05, n).astype(np.float32)
    return cost, np.ones((n, n), bool)


@pytest.mark.parametrize("max_iters", [1, 2, 3, 5, 2000])
@pytest.mark.parametrize("seed", [0, 1])
def test_xla_assign_stats_matches_jax_at_reachable_caps(seed, max_iters):
    """impl="xla" is JAX's: the warm-started auction from an empty carry,
    its loops tested every three rounds, so a cap can be overrun by up to
    two active rounds; row_to_col, iters and converged equal JAX's at caps
    that stop the solve and at the default one."""
    cost, feas = _contested(seed)
    got = t_assign.auction_assign_stats(torch.as_tensor(cost),
                                        torch.as_tensor(feas),
                                        max_iters=max_iters, impl="xla")
    want = j_assign.auction_assign_stats(jnp.asarray(cost),
                                         jnp.asarray(feas),
                                         max_iters=max_iters, impl="xla")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])
    assert bool(got[2]) == bool(want[2])
    if max_iters < 5:
        assert not bool(want[2])          # the cap did stop the solve
