"""ROI extraction through a mip pyramid: the CUDA kernels K1 and K3
(csrc/roi.cu) and their plain torch versions (counterpart of
tpu_mot/kernels/roi.py).  K1 (`extract_patches`) resamples one window per
track; K3 (`extract_patches_scales`) resamples K scaled windows per track
from one block, its level chosen from the largest scale.

Per track, the pyramid level is the one where the context window is at
most MAX_WIN px (`clip(ceil(log2(max(win/128, 1))), 0, 3)`), the sample
coordinates map to that level as `(y + .5)/2^lvl - .5` clamped to its true
extent, and the TPU kernel's (8,128)-aligned 144 x 256 block origin is
kept: taps outside that block get zero weight, so windows over 1024 px
are truncated exactly as on the TPU.  All of that coordinate math is
`sample_coords` (`sample_coords_scales` for K3), shared by the kernel and
its plain version; they differ only in the resample.  The plain version
forms the TPU kernel's one-hot hat-weight matmuls W_y . block . W_x^T; the
kernels evaluate the equal 4-tap form, which `four_tap_mirror` repeats in
torch so that the CPU tests can hold the kernels' tap rules to the plain
version.  Both kernels are one tile function: one CTA per (track, scale,
row tile) with the tile's taps in a shared-memory table, S = 64 compiled in
and any other S up to `max_scales_s()` read at run time (`SCALES_PATHS`);
K1 is its K = 1 case, under its own kernel name and with its own number of
rows per thread, and equals the mirror bit for bit on the card as K3 does.

Serving stacks the frames of S streams: `build_pyramid` of [S, H, W] gives
levels [S, H_l, W_l], and rows of the track axis are stream-major (row r
samples frame r // (rows / S)), so the kernels take the frame of a row
from one int, the rows per frame, and S = 1 is the single-frame launch.

u8 frames keep a u8 pyramid with the 1/255 dequantization folded into the
resample weights, as in JAX.  Float frames get a float32 pyramid (the JAX
default, bf16, is a TPU DMA-budget choice).  The port's levels are not
padded: `_level_shapes` (the JAX padded shapes) only bounds the block
origins.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tpu_mot_torch.kernels import _build

N_LEVELS = 4
BLK_ROWS = 144      # rows of the TPU kernel's window block
BLK_COLS = 256      # cols of the TPU kernel's window block
MAX_WIN = 128.0     # level chosen so the window is <= this many px

# Kernel launches made by `extract_patches` (K1) and by
# `extract_patches_scales` (K3): plain counts; reset them to 0 to measure a
# run.
launches = 0
launches_scales = 0


def _ceil_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=None)
def _level_shapes(h: int, w: int):
    """Padded (rows, cols) of each level in the JAX pyramid; they bound the
    block origins so that a full block stays inside the padded level."""
    shapes = []
    for lv in range(N_LEVELS):
        lh = -(-h // (1 << lv))
        lw = -(-w // (1 << lv))
        shapes.append((max(_ceil_mult(lh, 8), BLK_ROWS),
                       max(_ceil_mult(lw, 128), BLK_COLS)))
    return tuple(shapes)


def level_extents(h: int, w: int) -> tuple[tuple[int, int], ...]:
    """True (rows, cols) of each pyramid level of an h x w frame."""
    return tuple((-(-h // (1 << lv)), -(-w // (1 << lv)))
                 for lv in range(N_LEVELS))


@functools.lru_cache(maxsize=None)
def _level_tables(h: int, w: int, device: str):
    """Per-level true extents (float32 [4, 2]) and largest block origins
    (int32 [4, 2]) on `device`, built once so the per-frame path copies
    nothing from the host."""
    ext = torch.tensor(level_extents(h, w), dtype=torch.float32)
    max_origin = torch.tensor([(r - BLK_ROWS, c - BLK_COLS)
                               for r, c in _level_shapes(h, w)],
                              dtype=torch.int32)
    return ext.to(device), max_origin.to(device)


def _pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with stride 2 over the last two axes and zero
    padding at the high end of an odd extent — XLA's reduce_window "SAME",
    so an edge pixel averages with zeros (unlike avg_pool2d's default)."""
    h, w = x.shape[-2:]
    x = F.pad(x, (0, w % 2, 0, h % 2))
    return x.reshape(x.shape[:-2] + (x.shape[-2] // 2, 2,
                                     x.shape[-1] // 2, 2)).sum(
        dim=(-3, -1)) * 0.25


def build_pyramid(gray: torch.Tensor) -> list[torch.Tensor]:
    """[H, W] (or S frames [S, H, W]) uint8 or float -> N_LEVELS unpadded
    level images [H_l, W_l] ([S, H_l, W_l]); level k is a 2^k x 2^k average
    pool.

    A uint8 frame gives uint8 levels that hold 0..255 and round each pool
    back to u8 (`clip(pooled + 0.5)`).  A float frame gives float32 levels
    in [0, 1]; it may come in unit [0, 1] or byte [0, 255] domain: a
    max <= 1.5 selects unit (a traced select, no host sync), frame by
    frame, as the JAX pyramid under vmap.
    """
    u8 = gray.dtype == torch.uint8
    if not u8:
        gray = gray.to(torch.float32)
        unit = gray.amax(dim=(-2, -1), keepdim=True) <= 1.5
        gray = gray * torch.where(unit, 1.0, 1.0 / 255.0)
    levels = []
    cur = gray
    for lv in range(N_LEVELS):
        levels.append(cur.contiguous())
        if lv + 1 < N_LEVELS:
            pooled = _pool2x2(cur.to(torch.float32))
            cur = ((pooled + 0.5).clamp(0.0, 255.0).to(torch.uint8)
                   if u8 else pooled)
    return levels


def _block_origin(y0: torch.Tensor, x0: torch.Tensor,
                  max_origin: torch.Tensor):
    """The (8, 128)-aligned block origin at or before the first sample
    row/col y0, x0 [T], clamped to [0, max_origin [T, 2]] -> int32 r0, c0."""
    r0 = torch.div(torch.floor(y0).to(torch.int32), 8,
                   rounding_mode="floor") * 8
    c0 = torch.div(torch.floor(x0).to(torch.int32), 128,
                   rounding_mode="floor") * 128
    r0 = torch.minimum(torch.clamp_min(r0, 0), max_origin[:, 0])
    c0 = torch.minimum(torch.clamp_min(c0, 0), max_origin[:, 1])
    return r0.to(torch.int32), c0.to(torch.int32)


def sample_coords(boxes: torch.Tensor, padding: float, size: int,
                  frame_hw: tuple[int, int], scales=None):
    """Per-track level, block origin and level sample coordinates, ported
    exactly from tpu_mot/kernels/roi.py:449-517.

    boxes [T, 4] (cx, cy, w, h), scales optional [T] per-track factors ->
    lvl, r0, c0 int32 [T]; ys, xs float32 [T, size].
    """
    h, w = frame_hw
    ext, max_origin = _level_tables(h, w, str(boxes.device))
    cx, cy, bw, bh = boxes.unbind(1)
    bw = torch.clamp_min(bw, 1.0)
    bh = torch.clamp_min(bh, 1.0)
    if scales is not None:
        bw = bw * scales
        bh = bh * scales
    win_w = bw * padding
    win_h = bh * padding
    win = torch.maximum(win_w, win_h)
    lvl = torch.clamp(
        torch.ceil(torch.log2(torch.clamp_min(win / MAX_WIN, 1.0))),
        0, N_LEVELS - 1).to(torch.int32)
    li = lvl.long()
    scale = torch.exp2(lvl.to(torch.float32))
    lh = ext[li, 0]
    lw = ext[li, 1]
    u = (torch.arange(size, dtype=torch.float32, device=boxes.device)
         + 0.5) / size - 0.5
    ys = torch.minimum(torch.clamp_min(
        (cy[:, None] + u[None, :] * win_h[:, None] + 0.5) / scale[:, None]
        - 0.5, 0.0), (lh - 1.0)[:, None])
    xs = torch.minimum(torch.clamp_min(
        (cx[:, None] + u[None, :] * win_w[:, None] + 0.5) / scale[:, None]
        - 0.5, 0.0), (lw - 1.0)[:, None])
    return (lvl, *_block_origin(ys[:, 0], xs[:, 0], max_origin[li]), ys,
            xs)


def sample_coords_scales(boxes: torch.Tensor, padding: float, size: int,
                         scale_vals: tuple, frame_hw: tuple[int, int]):
    """K3's coordinates, ported exactly from tpu_mot/kernels/roi.py:378-410:
    one level per track, chosen from the LARGEST scale's window, and one
    block origin, at the smallest first row/col over the scales, so one
    block covers every scale's window.

    boxes [T, 4], scale_vals K Python floats -> lvl, r0, c0 int32 [T]; ys,
    xs float32 [K, T, size].
    """
    h, w = frame_hw
    ext, max_origin = _level_tables(h, w, str(boxes.device))
    cx, cy, bw, bh = boxes.unbind(1)
    bw = torch.clamp_min(bw, 1.0)
    bh = torch.clamp_min(bh, 1.0)
    smax = float(max(scale_vals))
    win_max = torch.maximum(bw, bh) * (padding * smax)
    lvl = torch.clamp(
        torch.ceil(torch.log2(torch.clamp_min(win_max / MAX_WIN, 1.0))),
        0, N_LEVELS - 1).to(torch.int32)
    li = lvl.long()
    scale = torch.exp2(lvl.to(torch.float32))[:, None]
    lh = (ext[li, 0] - 1.0)[:, None]
    lw = (ext[li, 1] - 1.0)[:, None]
    u = (torch.arange(size, dtype=torch.float32, device=boxes.device)
         + 0.5) / size - 0.5
    ys_k, xs_k = [], []
    for sv in scale_vals:
        win_w = bw * (padding * float(sv))
        win_h = bh * (padding * float(sv))
        ys_k.append(torch.minimum(torch.clamp_min(
            (cy[:, None] + u[None, :] * win_h[:, None] + 0.5) / scale - 0.5,
            0.0), lh))
        xs_k.append(torch.minimum(torch.clamp_min(
            (cx[:, None] + u[None, :] * win_w[:, None] + 0.5) / scale - 0.5,
            0.0), lw))
    ys = torch.stack(ys_k)                                   # [K, T, S]
    xs = torch.stack(xs_k)
    return (lvl, *_block_origin(ys[:, :, 0].amin(dim=0),
                                xs[:, :, 0].amin(dim=0), max_origin[li]),
            ys, xs)


def _pyramid(gray, levels, frame_hw):
    if levels is None:
        return build_pyramid(gray), tuple(gray.shape[-2:])
    if frame_hw is None:
        raise ValueError("frame_hw is required with a prebuilt pyramid")
    return levels, tuple(frame_hw)


def n_frames(levels) -> int:
    """Frames a pyramid holds: 1 for [H_l, W_l] levels, S for
    [S, H_l, W_l]."""
    return 1 if levels[0].ndim == 2 else levels[0].shape[0]


def rows_per_frame(levels, rows: int) -> int:
    """Rows of the track axis per frame of the pyramid: the rows are
    stream-major, row r samples frame r // rows_per_frame."""
    n = n_frames(levels)
    if rows % n:
        raise ValueError(f"{rows} rows are not a multiple of the pyramid's "
                         f"{n} frames")
    return rows // n


def _row_frames(levels, rows: int, device) -> torch.Tensor | None:
    """Frame index of each row [rows] for a stacked pyramid, else None."""
    if levels[0].ndim == 2:
        return None
    return torch.div(torch.arange(rows, device=device),
                     rows_per_frame(levels, rows), rounding_mode="floor")


def _gather_blocks(levels, frame_hw, lvl, r0, c0) -> torch.Tensor:
    """Each track's 144 x 256 block of its (zero-padded) level of its own
    frame, float32 [T, BLK_ROWS, BLK_COLS]."""
    dev = lvl.device
    shapes = _level_shapes(*frame_hw)
    rows = r0.long()[:, None] + torch.arange(BLK_ROWS, device=dev)
    cols = c0.long()[:, None] + torch.arange(BLK_COLS, device=dev)
    t = lvl.shape[0]
    frame = _row_frames(levels, t, dev)
    blk = torch.zeros((t, BLK_ROWS, BLK_COLS), dtype=torch.float32,
                      device=dev)
    for lv, level in enumerate(levels):
        ph, pw = shapes[lv]
        padded = F.pad(level, (0, pw - level.shape[-1],
                               0, ph - level.shape[-2]))
        # Other tracks' origins may lie past this level: clamp, discard.
        idx = (rows.clamp_max(ph - 1)[:, :, None],
               cols.clamp_max(pw - 1)[:, None, :])
        g = padded[idx] if frame is None else padded[
            (frame[:, None, None],) + idx]
        blk = torch.where((lvl == lv)[:, None, None],
                          g.to(torch.float32), blk)
    return blk


def _hat_resample(blk, r0, c0, ys, xs, u8: bool) -> torch.Tensor:
    """The TPU kernel's one-hot hat-weight matmuls W_y . blk . W_x^T on
    [T, S] block coordinates -> [T, S, S]."""
    dev = ys.device
    row_iota = torch.arange(BLK_ROWS, dtype=torch.float32, device=dev)
    col_iota = torch.arange(BLK_COLS, dtype=torch.float32, device=dev)
    ysl = ys - r0.to(torch.float32)[:, None]
    xsl = xs - c0.to(torch.float32)[:, None]
    wy = torch.clamp_min(1.0 - torch.abs(ysl[:, :, None] - row_iota), 0.0)
    wx = torch.clamp_min(1.0 - torch.abs(xsl[:, :, None] - col_iota), 0.0)
    if u8:
        wy = wy * (1.0 / 255.0)
    return torch.bmm(torch.bmm(wy, blk), wx.transpose(1, 2))


def _resample_ref(levels, frame_hw, lvl, r0, c0, ys, xs) -> torch.Tensor:
    """The TPU kernel's math in plain torch: gather each track's block from
    its (zero-padded) level and apply the hat-weight matmuls."""
    blk = _gather_blocks(levels, frame_hw, lvl, r0, c0)
    return _hat_resample(blk, r0, c0, ys, xs,
                         levels[0].dtype == torch.uint8)


def _resample_scales_ref(levels, frame_hw, lvl, r0, c0, ys, xs
                         ) -> torch.Tensor:
    """K3's math in plain torch: one block per track, K resamples of it."""
    blk = _gather_blocks(levels, frame_hw, lvl, r0, c0)
    u8 = levels[0].dtype == torch.uint8
    return torch.stack([_hat_resample(blk, r0, c0, ys[k], xs[k], u8)
                        for k in range(ys.shape[0])])


def four_tap_mirror(levels, frame_hw, lvl, r0, c0, ys, xs) -> torch.Tensor:
    """The CUDA kernels' arithmetic (csrc/roi.cu: `tap_of` and the 4-tap
    sum) in torch float32, on [K, T, S] level coordinates -> [K, T, S, S].

    Per axis a coordinate gives two taps: block-local y = coord - origin,
    taps floor(y) and floor(y) + 1 with hat weights max(0, 1 - |y - tap|);
    a tap outside the block [origin, origin + blk) or past the level's true
    extent gets weight 0 and its read is clamped into the level; u8
    pyramids fold 1/255 into the row weights.  An output is
    (rw0 p00 + rw1 p10) cw0 + (rw0 p01 + rw1 p11) cw1, each product and sum
    rounded to float32 as the kernels round them.  A stacked pyramid
    [S, H_l, W_l] is read at each row's frame, as the kernels read it."""
    ext = torch.tensor(level_extents(*frame_hw), dtype=torch.int64,
                       device=ys.device)
    li = lvl.long()
    lh, lw = ext[li, 0], ext[li, 1]                          # [T]

    def taps(coord, origin, blk, extent):
        origin = origin.long()[None, :, None]
        extent = extent[None, :, None]
        y = coord - origin.to(torch.float32)
        f = torch.floor(y)
        a = f.long()
        out = []
        for tap, tf in ((a, f), (a + 1, f + 1.0)):
            valid = (tap >= 0) & (tap < blk) & (origin + tap < extent)
            w = torch.clamp_min(1.0 - torch.abs(y - tf), 0.0)
            g = torch.minimum(torch.clamp_min(origin + tap, 0), extent - 1)
            out.append((g, torch.where(valid, w, torch.zeros_like(w))))
        return out

    (ri0, rw0), (ri1, rw1) = taps(ys, r0, BLK_ROWS, lh)
    (ci0, cw0), (ci1, cw1) = taps(xs, c0, BLK_COLS, lw)
    if levels[0].dtype == torch.uint8:
        rw0 = rw0 * (1.0 / 255.0)
        rw1 = rw1 * (1.0 / 255.0)
    # All levels as one flat image; a track reads at its level's offset,
    # plus its frame's within a stacked level.
    flat = torch.cat([lv.reshape(-1).to(torch.float32) for lv in levels])
    plane = ext[:, 0] * ext[:, 1]
    sizes = plane * n_frames(levels)
    offset = (torch.cumsum(sizes, 0) - sizes)[li]
    frame = _row_frames(levels, lvl.shape[0], ys.device)
    if frame is not None:
        offset = offset + frame * plane[li]
    offset = offset[None, :, None, None]
    stride = lw[None, :, None, None]

    def pixel(rows, cols):
        return flat[offset + rows[..., :, None] * stride + cols[..., None, :]]

    rw0, rw1 = rw0[..., :, None], rw1[..., :, None]
    t0 = rw0 * pixel(ri0, ci0) + rw1 * pixel(ri1, ci0)
    t1 = rw0 * pixel(ri0, ci1) + rw1 * pixel(ri1, ci1)
    return t0 * cw0[..., None, :] + t1 * cw1[..., None, :]


# The code paths of K1 and K3 (csrc/roi.cu, `resample_tile`), chosen by S
# alone.
SCALES_PATHS = ("row tiles, S read at run time", "row tiles, S = 64")


@functools.lru_cache(maxsize=None)
def max_scales_s() -> int:
    """The largest template size S that K1 and K3 take."""
    return _build.load().tpu_mot_roi_max_s()


def _launch_info(entry: str, u8: bool, s: int) -> dict:
    info = _build.launch_info(getattr(_build.load(), entry), int(u8), s)
    info["path"] = SCALES_PATHS[info["path"]]
    return info


def launch_info(u8: bool, s: int) -> dict:
    """What K1 launches for S x S templates from a u8 or float32 pyramid:
    code path (a name from SCALES_PATHS), threads, registers, shared
    memory, CTAs per SM."""
    return _launch_info("tpu_mot_roi_info", u8, s)


def scales_launch_info(u8: bool, s: int) -> dict:
    """The same for K3."""
    return _launch_info("tpu_mot_roi_scales_info", u8, s)


def _launch(what, entry, levels, frame_hw, lvl, r0, c0, ys, xs, out,
            rows, *dims) -> None:
    """Check what the kernels take and launch `entry` on the current
    stream over `rows` rows of the track axis; raises on anything else (no
    fallback)."""
    dev = ys.device
    dtype = levels[0].dtype
    if dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{what}: pyramid dtype {dtype} is not uint8 or "
                         "float32")
    ext = level_extents(*frame_hw)
    if len(levels) != N_LEVELS:
        raise ValueError(f"{what}: need {N_LEVELS} levels")
    lead = tuple(levels[0].shape[:-2])
    if len(lead) > 1 or lead == (0,):
        raise ValueError(f"{what}: levels must be [H_l, W_l] or "
                         f"[S, H_l, W_l], got {tuple(levels[0].shape)}")
    for lv, level in enumerate(levels):
        if (level.device != dev or level.dtype != dtype
                or tuple(level.shape) != lead + ext[lv]
                or not level.is_contiguous()):
            raise ValueError(
                f"{what}: level {lv} must be a contiguous {dtype} "
                f"{lead + ext[lv]} tensor on {dev}, got {level.dtype} "
                f"{tuple(level.shape)} on {level.device}")
    per_frame = rows_per_frame(levels, rows)
    ints = [x.to(torch.int32).contiguous() for x in (lvl, r0, c0)]
    ys = ys.to(torch.float32).contiguous()
    xs = xs.to(torch.float32).contiguous()
    scale = 1.0 / 255.0 if dtype == torch.uint8 else 1.0
    fn = getattr(_build.load(), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(int(dtype == torch.uint8), *[lv.data_ptr() for lv in levels],
                *[e[0] for e in ext], *[e[1] for e in ext],
                *[x.data_ptr() for x in ints], ys.data_ptr(), xs.data_ptr(),
                out.data_ptr(), rows, per_frame, *dims, BLK_ROWS, BLK_COLS,
                scale, stream)
    _build.check(rc, what)


def _check_size(what: str, s: int) -> None:
    if not 1 <= s <= max_scales_s():
        raise ValueError(f"{what}: template size S={s} outside "
                         f"1..{max_scales_s()}")


def _resample_cuda(levels, frame_hw, lvl, r0, c0, ys, xs,
                   rows_per_thread: int | None = None) -> torch.Tensor:
    """K1 on the card: [T, S] coordinates -> [T, S, S], row t sampling its
    frame of a stacked pyramid.  `rows_per_thread` (4, 2 or 1) launches
    that variant of the kernel instead of the one the library keeps
    (tools/kernel_cost.py measures the choice)."""
    global launches
    t, s = ys.shape
    out = torch.empty((t, s, s), dtype=torch.float32, device=ys.device)
    if t == 0:
        return out
    _check_size("extract_patches", s)
    if rows_per_thread is None:
        _launch("extract_patches", "tpu_mot_roi_extract", levels, frame_hw,
                lvl, r0, c0, ys, xs, out, t, s)
    else:
        _launch("extract_patches", "tpu_mot_roi_extract_rows", levels,
                frame_hw, lvl, r0, c0, ys, xs, out, t, s, rows_per_thread)
    launches += 1
    return out


def _resample_scales_cuda(levels, frame_hw, lvl, r0, c0, ys, xs
                          ) -> torch.Tensor:
    """K3 on the card: [K, T, S] coordinates -> [K, T, S, S], track t
    sampling its frame of a stacked pyramid."""
    global launches_scales
    k, t, s = ys.shape
    out = torch.empty((k, t, s, s), dtype=torch.float32, device=ys.device)
    if t == 0 or k == 0:
        return out
    _check_size("extract_patches_scales", s)
    _launch("extract_patches_scales", "tpu_mot_roi_extract_scales", levels,
            frame_hw, lvl, r0, c0, ys, xs, out, t, k, s)
    launches_scales += 1
    return out


def extract_patches_ref(gray, boxes, padding: float, size: int, levels=None,
                        frame_hw=None, scales=None) -> torch.Tensor:
    """Plain torch version of `extract_patches`, on any device."""
    levels, frame_hw = _pyramid(gray, levels, frame_hw)
    coords = sample_coords(boxes, padding, size, frame_hw, scales)
    return _resample_ref(levels, frame_hw, *coords)


def extract_patches(gray, boxes, padding: float, size: int, levels=None,
                    frame_hw=None, scales=None) -> torch.Tensor:
    """ROI extraction [H, W] frame + [T, 4] boxes (+ optional [T] per-track
    scales) -> [T, size, size].  Pass a prebuilt pyramid (`levels`,
    `frame_hw`) to share it across calls; a pyramid of S frames (or
    frames [S, H, W]) takes stream-major boxes, T/S a frame.

    K1 for CUDA tensors, the plain version for CPU tensors; raises on
    anything the kernel does not take."""
    levels, frame_hw = _pyramid(gray, levels, frame_hw)
    coords = sample_coords(boxes, padding, size, frame_hw, scales)
    if _build.on_card("extract_patches", boxes):
        return _resample_cuda(levels, frame_hw, *coords)
    return _resample_ref(levels, frame_hw, *coords)


def extract_patches_scales_ref(gray, boxes, padding: float, size: int,
                               scale_vals: tuple, levels=None, frame_hw=None
                               ) -> torch.Tensor:
    """Plain torch version of `extract_patches_scales`, on any device."""
    levels, frame_hw = _pyramid(gray, levels, frame_hw)
    coords = sample_coords_scales(boxes, padding, size, scale_vals, frame_hw)
    return _resample_scales_ref(levels, frame_hw, *coords)


def extract_patches_scales(gray, boxes, padding: float, size: int,
                           scale_vals: tuple, levels=None, frame_hw=None
                           ) -> torch.Tensor:
    """Scale-pyramid ROI extraction, one block per track: [H, W] frame +
    [T, 4] boxes + K scales -> [K, T, size, size] (scale-major).  A
    pyramid of S frames takes stream-major boxes, T/S a frame.

    Against K separate `extract_patches` calls it differs only in the
    level: one per track, from the largest scale's window (tracks whose
    windows straddle a level boundary sample the coarser level at every
    scale), as tpu_mot/kernels/roi.extract_patches_scales_pallas does.
    K3 for CUDA tensors, the plain version for CPU tensors."""
    levels, frame_hw = _pyramid(gray, levels, frame_hw)
    coords = sample_coords_scales(boxes, padding, size, scale_vals, frame_hw)
    if _build.on_card("extract_patches_scales", boxes):
        return _resample_scales_cuda(levels, frame_hw, *coords)
    return _resample_scales_ref(levels, frame_hw, *coords)
