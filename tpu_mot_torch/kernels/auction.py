"""Auction assignment solve: the CUDA kernel (csrc/auction.cu) and its plain
torch version (counterpart of tpu_mot/kernels/auction.py).

Both run the same Jacobi gap-bidding auction at a fixed eps on a squared
benefit matrix b [n, n] (built by ops/assignment.build_benefits): every
unassigned row bids p[c*] + (m1 - m2) + eps on its first-maximum column
c*, every column takes its highest bid (lowest row on ties) and evicts its
owner, until no row is unassigned or max_iters rounds have run.  They
return col_of [n] int32 (-1 rows only when capped) and iters [] int32,
bit-identical to each other and to the TPU kernel.
"""

from __future__ import annotations

import torch

from tpu_mot_torch.kernels import _build

_NEG = -1.0e30

# Kernel launches made by `auction_solve` (a plain count; reset it to 0 to
# measure a run).
launches = 0


def auction_solve_ref(b: torch.Tensor, eps: float, max_iters: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch auction on any device (one host sync per round)."""
    n = b.shape[0]
    dev = b.device
    ci = torch.arange(n, device=dev)
    prices = torch.zeros((n,), dtype=torch.float32, device=dev)
    col_of = torch.full((n,), -1, dtype=torch.long, device=dev)
    row_of = torch.full((n,), -1, dtype=torch.long, device=dev)
    it = 0
    while it < max_iters and bool((col_of < 0).any()):
        bidding = col_of < 0                                   # [n]
        values = b - prices[None, :]                           # [n, n]
        m1 = values.max(dim=1).values
        c_star = torch.argmax(values, dim=1)                   # first max
        star = ci[None, :] == c_star[:, None]                  # [n, n]
        m2 = torch.where(star, _NEG, values).max(dim=1).values
        m2 = torch.where(m2 <= _NEG * 0.5, m1, m2)
        bid = prices[c_star] + (m1 - m2) + eps
        bids = torch.where(star & bidding[:, None], bid[:, None], _NEG)
        best_bid = bids.max(dim=0).values                      # [n]
        winner = torch.argmax(bids, dim=0)                     # lowest row
        has_bid = best_bid > _NEG * 0.5
        evict = has_bid[None, :] & (row_of[None, :] == ci[:, None])
        was_evicted = evict.any(dim=1)
        win = has_bid[None, :] & (winner[None, :] == ci[:, None])
        won_col = torch.where(win, ci[None, :], -1).max(dim=1).values
        col_of = torch.where(won_col >= 0, won_col,
                             torch.where(was_evicted, -1, col_of))
        row_of = torch.where(has_bid, winner, row_of)
        prices = torch.where(has_bid, best_bid, prices)
        it += 1
    return (col_of.to(torch.int32),
            torch.tensor(it, dtype=torch.int32, device=dev))


def max_n() -> int:
    """Largest n whose matrix and state fit in one CTA's shared memory."""
    return _build.load().tpu_mot_auction_max_n()


def auction_solve(b: torch.Tensor, eps: float, max_iters: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve on b [n, n] float32: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Raises on anything the kernel does not
    take; never falls back."""
    global launches
    if not _build.on_card("auction_solve", b):
        return auction_solve_ref(b, eps, max_iters)
    if b.dtype != torch.float32 or b.ndim != 2 or b.shape[0] != b.shape[1]:
        raise ValueError("auction_solve: b must be a square float32 matrix, "
                         f"got {tuple(b.shape)} {b.dtype}")
    if not b.is_contiguous():
        raise ValueError("auction_solve: b must be contiguous")
    n = b.shape[0]
    if not 1 <= n <= max_n():
        raise ValueError(
            f"auction_solve: n={n} outside 1..{max_n()} (the matrix must "
            "fit in one CTA's shared memory)")
    if max_iters < 0:
        raise ValueError("auction_solve: max_iters must be >= 0")
    col_of = torch.empty((n,), dtype=torch.int32, device=b.device)
    iters = torch.empty((), dtype=torch.int32, device=b.device)
    lib = _build.load()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpu_mot_auction_solve(b.data_ptr(), col_of.data_ptr(),
                                       iters.data_ptr(), n, float(eps),
                                       int(max_iters), stream)
    _build.check(rc, "auction_solve")
    launches += 1
    return col_of, iters
