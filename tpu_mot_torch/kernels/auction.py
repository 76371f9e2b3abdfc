"""Auction assignment solve: the CUDA kernel (csrc/auction.cu) and its plain
torch version (counterpart of tpu_mot/kernels/auction.py).

Both run the same Jacobi gap-bidding auction at a fixed eps on a squared
benefit matrix b [n, n] (built by ops/assignment.build_benefits): every
unassigned row bids p[c*] + (m1 - m2) + eps on its first-maximum column
c*, every column takes its highest bid (lowest row on ties) and evicts its
owner, until no row is unassigned or max_iters rounds have run.  They
return col_of [n] int32 (-1 rows only when capped) and iters [] int32,
bit-identical to each other and to the TPU kernel.

Serving solves S problems at once: b [S, n, n] -> col_of [S, n], iters
[S], one CTA per problem on the card.  Each problem is solved as if alone
(the plain version freezes a problem once it is assigned, the way the JAX
kernel runs under vmap), so each equals the single solve.
"""

from __future__ import annotations

import functools

import torch

from tpu_mot_torch.kernels import _build

_NEG = -1.0e30

# Kernel launches made by `auction_solve` (a plain count; reset it to 0 to
# measure a run).
launches = 0


def auction_solve_ref(b: torch.Tensor, eps: float, max_iters: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch auction on any device (one host sync per round), on b
    [n, n] or a batch [S, n, n].  A problem with no unassigned row bids
    nothing, so a round leaves it as it was; only its round count stops."""
    single = b.ndim == 2
    if single:
        b = b[None]
    s, n = b.shape[0], b.shape[-1]
    dev = b.device
    ci = torch.arange(n, device=dev)
    prices = torch.zeros((s, n), dtype=torch.float32, device=dev)
    col_of = torch.full((s, n), -1, dtype=torch.long, device=dev)
    row_of = torch.full((s, n), -1, dtype=torch.long, device=dev)
    iters = torch.zeros((s,), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters:
        active = (col_of < 0).any(dim=1)                       # [S]
        if not bool(active.any()):
            break
        bidding = col_of < 0                                   # [S, n]
        values = b - prices[:, None, :]                        # [S, n, n]
        m1 = values.max(dim=2).values
        c_star = torch.argmax(values, dim=2)                   # first max
        star = ci == c_star[..., None]                         # [S, n, n]
        m2 = torch.where(star, _NEG, values).max(dim=2).values
        m2 = torch.where(m2 <= _NEG * 0.5, m1, m2)
        bid = prices.gather(1, c_star) + (m1 - m2) + eps
        bids = torch.where(star & bidding[..., None], bid[..., None], _NEG)
        best_bid = bids.max(dim=1).values                      # [S, n]
        winner = torch.argmax(bids, dim=1)                     # lowest row
        has_bid = best_bid > _NEG * 0.5
        evict = has_bid[:, None, :] & (row_of[:, None, :] == ci[:, None])
        was_evicted = evict.any(dim=2)
        win = has_bid[:, None, :] & (winner[:, None, :] == ci[:, None])
        won_col = torch.where(win, ci, -1).max(dim=2).values
        col_of = torch.where(won_col >= 0, won_col,
                             torch.where(was_evicted, -1, col_of))
        row_of = torch.where(has_bid, winner, row_of)
        prices = torch.where(has_bid, best_bid, prices)
        iters = iters + active.to(torch.int32)
        it += 1
    col_of = col_of.to(torch.int32)
    return (col_of[0], iters[0]) if single else (col_of, iters)


def bid_keys(bid: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the kernel's 64-bit bid key, as int64 whose order is
    the kernel's unsigned order: the bid's float32 bits mapped to an
    order-preserving integer above bit 32, `0xFFFFFFFF - row` below.  The
    largest key of a set is the highest bid and, among equal bids, the
    lowest row.  (The kernel sets the top bit of a positive bid's word and
    compares unsigned; here the sign bit does the same for a signed
    compare.)"""
    bits = bid.to(torch.float32).contiguous().view(torch.int32).long()
    return _flip_negative(bits) * 2 ** 32 + (0xFFFFFFFF - rows.long())


def _flip_negative(bits: torch.Tensor) -> torch.Tensor:
    """float32 bits (int64 holding an int32) <-> integers in float order;
    its own inverse."""
    return torch.where(bits >= 0, bits, -(2 ** 31) - 1 - bits)


def split_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `bid_keys`: (bid float32, row int64)."""
    bits = _flip_negative(keys >> 32)
    return (bits.to(torch.int32).view(torch.float32),
            0xFFFFFFFF - (keys & 0xFFFFFFFF))


def auction_solve_scatter_ref(b: torch.Tensor, eps: float, max_iters: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's round in plain torch: every bidding row scatters its
    keyed bid to its column (a max per column), then one step per column
    with a key gives it to the winner, evicts the old owner and sets owner
    and price.  Same col_of and iters as `auction_solve_ref`; tests hold
    the two together so the kernel's schedule is checked on the CPU.  A
    batch [S, n, n] is solved problem by problem, as the kernel's CTAs
    solve it."""
    if b.ndim == 3:
        outs = [auction_solve_scatter_ref(x, eps, max_iters) for x in b]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    n = b.shape[0]
    dev = b.device
    ri = torch.arange(n, device=dev)
    prices = torch.zeros((n,), dtype=torch.float32, device=dev)
    col_of = torch.full((n,), -1, dtype=torch.long, device=dev)
    row_of = torch.full((n,), -1, dtype=torch.long, device=dev)
    no_key = torch.iinfo(torch.int64).min
    unassigned, it = n, 0
    while it < max_iters and unassigned > 0:
        rows = ri[col_of < 0]
        values = b[rows] - prices[None, :]
        m1 = values.max(dim=1).values
        c_star = torch.argmax(values, dim=1)                   # first max
        rest = values.scatter(1, c_star[:, None], _NEG)
        m2 = rest.max(dim=1).values
        m2 = torch.where(m2 <= _NEG * 0.5, m1, m2)
        bid = prices[c_star] + (m1 - m2) + eps
        keys = torch.full((n,), no_key, dtype=torch.int64, device=dev)
        keys.scatter_reduce_(0, c_star, bid_keys(bid, rows), "amax")
        cols = ri[keys != no_key]
        best_bid, winner = split_keys(keys[cols])
        old = row_of[cols]
        col_of[winner] = cols
        col_of[old[old >= 0]] = -1
        row_of[cols] = winner
        prices[cols] = best_bid
        unassigned -= int((old < 0).sum())
        it += 1
    return (col_of.to(torch.int32),
            torch.tensor(it, dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=None)
def max_n() -> int:
    """Largest n the kernel solves: one thread per column (1024)."""
    return _build.load().tpu_mot_auction_max_n()


@functools.lru_cache(maxsize=None)
def shared_max_n() -> int:
    """Largest n whose matrix and state fit in one CTA's shared memory
    (237); larger problems read their rows from global memory."""
    return _build.load().tpu_mot_auction_shared_max_n()


PATHS = ("scalar loads into padded rows", "bulk asynchronous copy",
         "rows from global memory by scalar loads",
         "rows from global memory as float4")


def launch_info(n: int) -> dict:
    """What the kernel launches for a (16-byte aligned) matrix of n
    columns: path (a name from PATHS: the matrix staged into shared memory
    up to shared_max_n() columns, read from global memory above it),
    threads, registers, shared memory, CTAs per SM (per problem: a batch
    launches one CTA each)."""
    info = _build.launch_info(_build.load().tpu_mot_auction_info, n)
    info["path"] = PATHS[info["path"]]
    return info


def auction_solve(b: torch.Tensor, eps: float, max_iters: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve on b [n, n] float32 (col_of [n], iters []) or on a batch of
    problems [S, n, n] (col_of [S, n], iters [S]): the CUDA kernel for a
    CUDA tensor, one launch and one CTA per problem; the plain version for
    a CPU tensor.  Raises on anything the kernel does not take; never
    falls back."""
    global launches
    if not _build.on_card("auction_solve", b):
        return auction_solve_ref(b, eps, max_iters)
    if (b.dtype != torch.float32 or b.ndim not in (2, 3)
            or b.shape[-1] != b.shape[-2]):
        raise ValueError("auction_solve: b must be a square float32 matrix "
                         f"or a batch of them, got {tuple(b.shape)} "
                         f"{b.dtype}")
    if not b.is_contiguous():
        raise ValueError("auction_solve: b must be contiguous")
    n = b.shape[-1]
    batch = tuple(b.shape[:-2])
    limit = max_n()
    if not 1 <= n <= limit:
        raise ValueError(
            f"auction_solve: n={n} outside 1..{limit} (the kernel runs a "
            f"thread per column, at most {limit})")
    if max_iters < 0:
        raise ValueError("auction_solve: max_iters must be >= 0")
    col_of = torch.empty(batch + (n,), dtype=torch.int32, device=b.device)
    iters = torch.empty(batch, dtype=torch.int32, device=b.device)
    if iters.numel() == 0:
        return col_of, iters
    lib = _build.load()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpu_mot_auction_solve(b.data_ptr(), col_of.data_ptr(),
                                       iters.data_ptr(), n, iters.numel(),
                                       float(eps), int(max_iters), stream)
    _build.check(rc, "auction_solve")
    launches += 1
    return col_of, iters
