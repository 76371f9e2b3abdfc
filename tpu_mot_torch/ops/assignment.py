"""Min-cost assignment by a Jacobi gap-bidding auction (counterpart of
tpu_mot/ops/assignment.py).

The problem is squared to n = max(N, M) with dummy columns, dead rows
become neutral zero filler, infeasible pairs sit at benefit -8, and a
row/column jitter far below eps breaks ties between identical rows
(`build_benefits`, the same matrix the JAX solvers build).  The solve
itself is kernels/auction.py: the CUDA kernel for a CUDA tensor, its plain
torch version on the CPU.  `auction_assign_warm` is the warm-started solve
in plain torch, as it is plain XLA in the JAX package (it never reaches the
kernel).  `scipy_assign` is the exact host reference.

The solvers take an optional leading batch axis (serving: one problem per
stream, [S, N, M]); each problem of a batch is solved as if alone, as the
JAX functions are under vmap.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mot_torch.kernels import auction as auction_k

COST_CAP = 4.0
_NEG = -8.0          # benefit of an infeasible pair (below the 0 of dummies)
DEFAULT_EPS = 0.02   # auction epsilon in cost units; suboptimality <= n*eps

# Loop checks made by `auction_assign_warm`, each one a host sync on a CUDA
# tensor (a plain count; reset it to 0 to measure a run).
warm_checks = 0


def build_benefits(cost: torch.Tensor, feasible: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Squared benefit matrix [..., n, n], n = max(N, M), of cost
    [..., N, M]: feasible costs map to [1, 1 + COST_CAP], infeasible pairs
    to -8, dead rows to 0, dummies pad at 0, plus the
    ((7r + 13c) % 29) * eps/116 tie-break jitter."""
    n_rows, m_cols = cost.shape[-2:]
    n = max(n_rows, m_cols)
    b = torch.where(feasible,
                    torch.clamp(COST_CAP - cost, 0.0, COST_CAP) + 1.0,
                    _NEG)
    row_dead = ~torch.any(feasible, dim=-1)
    b = torch.where(row_dead[..., None], 0.0, b)
    b = torch.nn.functional.pad(b, (0, n - m_cols, 0, n - n_rows))
    idx = torch.arange(n, dtype=torch.int32, device=cost.device)
    jitter = (idx[:, None] * 7 + idx[None, :] * 13) % 29
    return b + jitter.to(torch.float32) * (0.25 * eps / 29.0)


def strip_to_rows(col_of: torch.Tensor, feasible: torch.Tensor,
                  n_rows: int, m_cols: int) -> torch.Tensor:
    """Squared-problem solution [..., n] -> per-row matches [..., n_rows]
    (-1 for dummy columns, infeasible pairs and rows left unassigned at a
    cap)."""
    col_of = col_of[..., :n_rows].long()
    matched_real = (col_of >= 0) & (col_of < m_cols)
    ok = matched_real & feasible.gather(
        -1, col_of.clamp(0, m_cols - 1)[..., None])[..., 0]
    return torch.where(ok, col_of, -1).to(torch.int32)


def auction_assign(cost: torch.Tensor, feasible: torch.Tensor,
                   eps: float = DEFAULT_EPS, max_iters: int = 2000,
                   impl: str = "auto") -> torch.Tensor:
    """Solve min-cost assignment; returns row_to_col [..., N] int32, -1 =
    unmatched (auction_assign_stats without its statistics)."""
    return auction_assign_stats(cost, feasible, eps, max_iters, impl)[0]


def auction_assign_stats(cost: torch.Tensor, feasible: torch.Tensor,
                         eps: float = DEFAULT_EPS, max_iters: int = 2000,
                         impl: str = "auto"
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve min-cost assignment on cost [..., N, M]: returns (row_to_col
    [..., N] int32 with -1 = unmatched, iters [...] int32, converged [...]
    bool).  A batch [S, N, M] is one kernel launch.

    impl: "pallas" or "auto" go through the kernel wrapper
    (kernels/auction.auction_solve: the CUDA kernel for a CUDA tensor, the
    plain version on the CPU); "xla" calls the plain version directly.
    """
    n_rows, m_cols = cost.shape[-2:]
    lead = tuple(cost.shape[:-2])
    dev = cost.device
    if n_rows == 0 or m_cols == 0:
        return (torch.full(lead + (n_rows,), -1, dtype=torch.int32,
                           device=dev),
                torch.zeros(lead, dtype=torch.int32, device=dev),
                torch.ones(lead, dtype=torch.bool, device=dev))
    b = build_benefits(cost, feasible, eps)
    solve = (auction_k.auction_solve_ref if impl == "xla"
             else auction_k.auction_solve)
    col_of, iters = solve(b, eps, max_iters)
    converged = torch.all(col_of >= 0, dim=-1)
    return strip_to_rows(col_of, feasible, n_rows, m_cols), iters, converged


def auction_assign_warm(cost: torch.Tensor, feasible: torch.Tensor,
                        init_prices: torch.Tensor, init_col_of: torch.Tensor,
                        eps: float = DEFAULT_EPS, max_iters: int = 2000,
                        warm_budget: int = 6
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """Warm-started auction (Bertsekas' dynamic assignment), ported from
    tpu_mot/ops/assignment.auction_assign_warm: returns (row_to_col [N]
    int32, iters [] int32, converged [] bool, prices [n] float32, col_of [n]
    int32), n = max(N, M); with a leading batch axis (cost [S, N, M], the
    carry [S, n]) every output gains it.

    init_prices [n] and init_col_of [n] (row -> column of the carried
    matching, -1 = none, no column repeated) are a previous call's last two
    outputs; zeros / -1 give the cold solve.  Every carried pair is checked
    against eps-complementary slackness under the new benefits: three
    passes keep the pairs within eps of their row's best value and zero the
    price of every column outside the kept matching.  A warm phase of at
    most `warm_budget` active rounds re-auctions the violators; if it runs
    out and pairs were carried, the state resets to the cold start (zero
    prices, empty matching, the round count kept) and the standard auction
    finishes under `max_iters`.  With an empty carry the warm phase is the
    cold solve and the second loop continues it.

    `iters` counts active rounds.  The loops test their condition every
    three rounds, as the JAX while_loop does, so up to max_iters + 2 active
    rounds can run.  A batch runs as the JAX loop does under vmap: while
    any problem's condition holds, and a problem whose condition fails
    keeps its state, so each problem's outputs equal an unbatched call's.
    In eager PyTorch each test reads a tensor on the host: on a CUDA tensor
    that is a sync, at least two a call (`warm_checks` counts them).
    """
    global warm_checks
    single = cost.ndim == 2
    if single:
        cost, feasible = cost[None], feasible[None]
        init_prices, init_col_of = init_prices[None], init_col_of[None]
    n_str, n_rows, m_cols = cost.shape
    dev = cost.device

    def out(*xs):
        return tuple(x[0] for x in xs) if single else xs

    if n_rows == 0 or m_cols == 0:
        return out(
            torch.full((n_str, n_rows), -1, dtype=torch.int32, device=dev),
            torch.zeros((n_str,), dtype=torch.int32, device=dev),
            torch.ones((n_str,), dtype=torch.bool, device=dev),
            init_prices.to(torch.float32), init_col_of.to(torch.int32))
    n = max(n_rows, m_cols)
    if (tuple(init_prices.shape) != (n_str, n)
            or tuple(init_col_of.shape) != (n_str, n)):
        raise ValueError(
            f"init_prices/init_col_of must be [{n}] (squared problem size) "
            f"per problem, got {tuple(init_prices.shape)}/"
            f"{tuple(init_col_of.shape)}")
    b = build_benefits(cost, feasible, eps)                    # [S, n, n]
    iota = torch.arange(n, device=dev)
    row_iota = iota[:, None]
    col_iota = iota[None, :]
    neg_inf = float("-inf")

    def round_(prices, col_of, row_of, it):
        bidding = col_of < 0                                   # [S, n]
        values = b - prices[:, None, :]                        # [S, n, n]
        m1 = values.max(dim=2).values
        j_star = torch.argmax(values, dim=2)                   # first max
        star = col_iota == j_star[..., None]
        m2 = torch.where(star, neg_inf, values).max(dim=2).values
        m2 = torch.where(torch.isfinite(m2), m2, m1)           # one column
        bid = prices.gather(1, j_star) + (m1 - m2) + eps
        # Column-wise best bid (a Jacobi round); the lowest row on ties.
        bids = torch.where(star & bidding[..., None], bid[..., None],
                           neg_inf)
        best_bid = bids.max(dim=1).values
        winner = torch.argmax(bids, dim=1)
        has_bid = torch.isfinite(best_bid)
        was_evicted = (has_bid[:, None, :]
                       & (row_of[:, None, :] == row_iota)).any(dim=2)
        win = has_bid[:, None, :] & (winner[:, None, :] == row_iota)
        won_col = torch.where(win, col_iota, -1).max(dim=2).values
        col_of = torch.where(won_col >= 0, won_col,
                             torch.where(was_evicted, -1, col_of))
        row_of = torch.where(has_bid, winner, row_of)
        prices = torch.where(has_bid, best_bid, prices)
        # Only active rounds count: up to two rounds after convergence are
        # no-ops.
        return (prices, col_of, row_of,
                it + bidding.any(dim=1).to(torch.int32))

    def solve(state, limit: int):
        global warm_checks
        while True:
            warm_checks += 1
            go = (state[1] < 0).any(dim=1) & (state[3] < limit)    # [S]
            if not bool(go.any()):
                return state
            new = state
            for _ in range(3):
                new = round_(*new)
            # A problem whose loop has ended keeps its state (vmap's
            # select); a lone problem is still going here.
            state = new if n_str == 1 else tuple(
                torch.where(go.reshape((-1,) + (1,) * (x.ndim - 1)), x, old)
                for x, old in zip(new, state))

    # Re-validate the carried matching under the new benefits.  p0 stays the
    # vector the last keep-check ran against, so kept pairs satisfy eps-CS
    # with respect to the prices the solve starts from.
    p_carried = init_prices.to(torch.float32)
    c0 = init_col_of.long()
    pair_mask = col_iota == c0[..., None]                      # [S, n, n]
    keep = c0 >= 0
    p0 = p_carried
    for _ in range(3):
        col_kept = (pair_mask & keep[..., None]).any(dim=1)
        p0 = torch.where(col_kept, p_carried, 0.0)
        values0 = b - p0[:, None, :]
        m1_0 = values0.max(dim=2).values
        v_at = torch.where(pair_mask, values0, neg_inf).max(dim=2).values
        keep = keep & (v_at >= m1_0 - eps)
    col_of0 = torch.where(keep, c0, -1)
    row_of0 = torch.where(pair_mask & keep[..., None], row_iota,
                          -1).max(dim=1).values

    # Phase 1: the budgeted warm solve from the carried state.
    w_prices, w_col, w_row, w_it = solve(
        (p0, col_of0, row_of0, torch.zeros((n_str,), dtype=torch.int32,
                                           device=dev)),
        min(warm_budget, max_iters))
    # Phase 2: the cold fallback, only if the budget ran out on a state
    # that started from carried pairs (a select: no host decision).
    reset = ((w_col < 0).any(dim=1) & keep.any(dim=1))[:, None]
    prices, col_of, _, iters = solve(
        (torch.where(reset, 0.0, w_prices), torch.where(reset, -1, w_col),
         torch.where(reset, -1, w_row), w_it), max_iters)
    converged = torch.all(col_of >= 0, dim=1)
    return out(strip_to_rows(col_of, feasible, n_rows, m_cols), iters,
               converged, prices, col_of.to(torch.int32))


def scipy_assign(cost: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """Host-side exact reference (scipy Hungarian), same interface as the
    auction: row_to_col [N] int32, -1 = unmatched."""
    from scipy.optimize import linear_sum_assignment

    n, _ = cost.shape
    big = COST_CAP * 10.0
    c = np.where(feasible, cost, big)
    rows, cols = linear_sum_assignment(c)
    out = np.full((n,), -1, np.int32)
    for r, cc in zip(rows, cols):
        if feasible[r, cc]:
            out[r] = cc
    return out


def assignment_cost(cost: np.ndarray, row_to_col: np.ndarray) -> float:
    """Total cost of matched pairs (for optimality comparison in tests)."""
    total = 0.0
    for r, c in enumerate(row_to_col):
        if c >= 0:
            total += float(cost[r, c])
    return total
