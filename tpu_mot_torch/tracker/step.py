"""The per-frame MOT step (counterpart of tpu_mot/tracker/step.py):

  1. Kalman predict (batched)
  2. KCF detect at the predicted ROIs with the PSR gate -> refined boxes:
     gray or fHOG-31 features at one scale or three (ops/kcf.search: the
     scales folded scale-major beside the track axis, hysteresis-weighted
     best peak; PSR of the unit-scale response).  Under detect-site
     training a slot's first post-birth frame gets no KCF refinement.
  3. Cost: IoU (of the "refined" or "predicted" box, or the better of the
     two under assoc_box="best"), blended with the appearance term (each
     track's response read at each detection's place) when
     appearance_weight > 0; gated by IoU and, under class_aware, by class
  4. Auction assignment: the auction kernel, or under auction_warm_start
     the warm-started solve from the prices and matching the bank carries
  5. Kalman correct: matched slots with their detection, unmatched slots
     with a trusted KCF peak with the KCF position
  6/7. Lifecycle by masking: confirmations, deaths, births into the
     lowest-index empty slots
  8. KCF training, per train_site: "detect" phase-aligns the unit-scale
     step-2 spectra to the corrected centers (Fourier shift) and blends per
     slot (lr = 1 on the first post-birth frame, interp_factor when matched
     or trusted, 0 else); "refined" re-extracts at the corrected boxes and
     trains and blends there (lr = 1 for births).

The step is branch-free on tensor values, like the JAX step: no `.item()`
and no Python `if` on a tensor, so on the card it queues its kernels
without a host sync.  The one exception is auction_warm_start: the warm
auction is plain torch, and each test of its loops reads a tensor on the
host, at least two syncs a frame (ops/assignment.auction_assign_warm).
Its one body, `step_streams`, runs S streams at once (serving,
parallel/serve.py): every bank field gains a leading [S] and the
per-track math runs on [S*T] rows; `step` is that body at S = 1.
Under a torch.profiler capture the step is the span `tracker.step` and
each numbered stage a span inside it (utils/profiling.py lists them).
Scatters with JAX's mode="drop" write into one extra dump column per
stream that is sliced off.

How the step reads the TrackerConfig impl knobs (kcf_impl is passed on to
ops/kcf, whose `search` documents it):

  roi_impl    "auto"    pyramid + the CUDA ROI kernels (K1; K3 for the
                        3-scale search) for a CUDA frame, the gather path on
                        the CPU (JAX's TPU/CPU split)
              "pallas"  pyramid + the kernel wrappers: the CUDA kernels on
                        the card, their plain versions on the CPU, as JAX
                        runs the Pallas kernels in interpret mode
              "xla"     the gather path
  assign_impl "auto"/"pallas" the auction kernel wrapper (CUDA kernel on the
                        card, plain version on the CPU); "xla" JAX's "xla"
                        solve, the warm-started auction from an empty carry
                        in plain torch
  auction_warm_start    the warm-started auction in plain torch, whatever
                        assign_impl says (it bypasses the kernel in JAX
                        too); a bank whose carry is not [max(T, D)] falls
                        back to the cold solve
  kcf_precision, kcf_block, scan_unroll: ignored (TPU-only; fp32 here)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.kernels import roi
from tpu_mot_torch.ops import assignment
from tpu_mot_torch.ops import features as feat_ops
from tpu_mot_torch.ops import fft as fft_ops
from tpu_mot_torch.ops import iou as iou_ops
from tpu_mot_torch.ops import kalman
from tpu_mot_torch.ops import kcf as kcf_ops
from tpu_mot_torch.ops import patch as patch_ops
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker.bank import CONFIRMED, EMPTY, TENTATIVE, TrackBank
from tpu_mot_torch.utils.profiling import span


class StepOutput(NamedTuple):
    """Per-frame result, dense over slots (mask with `valid`); from
    `step_streams` every field has a leading [S]."""
    ids: torch.Tensor            # [T] int32
    boxes: torch.Tensor          # [T, 4] cx cy w h
    scores: torch.Tensor         # [T] float32
    valid: torch.Tensor          # [T] bool, confirmed tracks this frame
    matched_det: torch.Tensor    # [T] int32 det index or -1
    cls: torch.Tensor            # [T] int32 (0 without a class column)
    n_alive: torch.Tensor        # [] int32
    n_births: torch.Tensor       # [] int32
    n_deaths: torch.Tensor       # [] int32
    n_matches: torch.Tensor      # [] int32
    assign_iters: torch.Tensor   # [] int32 auction rounds this frame
    assign_converged: torch.Tensor  # [] bool


def _roi_kernel_path(cfg: TrackerConfig, frame: torch.Tensor) -> bool:
    if not cfg.use_kcf or cfg.roi_impl == "xla":
        return False
    return cfg.roi_impl == "pallas" or frame.is_cuda


def _features_at(gray, boxes, cfg: TrackerConfig, levels, frame_hw, frame,
                 scales=(1.0,), scale_vals=None) -> torch.Tensor:
    """Features [K, N, C, F, F] of the windows at `boxes` [N, 4] at the K
    `scales` (scale-major): through the pyramid and the ROI kernel wrappers
    when `levels` is given (stream-major boxes, N/S a frame; K1 at unit
    scale, else K3, one block per box for all K), else the gather path (box
    n in frame `frame[n]`, the scales from `scale_vals` [K])."""
    k, n = len(scales), boxes.shape[0]
    if k == 1:
        patches = patch_ops.extract_patches_auto(
            gray, boxes, cfg.kcf.padding, cfg.kcf.template_size,
            impl="xla" if levels is None else "pallas", levels=levels,
            frame_hw=frame_hw, frame=frame)
    elif levels is not None:
        patches = roi.extract_patches_scales(
            gray, boxes, cfg.kcf.padding, cfg.kcf.template_size, scales,
            levels=levels, frame_hw=frame_hw)
    else:
        patches = patch_ops.extract_patches_auto(
            gray, boxes.repeat(k, 1), cfg.kcf.padding, cfg.kcf.template_size,
            scales=scale_vals.repeat_interleave(n), impl="xla",
            frame=frame.repeat(k))
    feats = feat_ops.extract_features(
        patches.reshape((k * n,) + patches.shape[-2:]), cfg.kcf)
    return feats.reshape((k, n) + feats.shape[1:])


def _sample_response(response: torch.Tensor, centers: torch.Tensor,
                     win: torch.Tensor, det_centers: torch.Tensor,
                     size: int) -> torch.Tensor:
    """The appearance term: track t's correlation response read bilinearly
    at detection d's place in t's search window -> [S, T, D]; 0 where the
    detection lies outside the window.

    response [S*T, size, size]; centers, win [S*T, 2] (predicted centers,
    window (w, h)), stream-major; det_centers [S, D, 2], each stream's
    detections.  The sample is two hat-weight products, as in the JAX step
    (weights nonzero at the two bracketing pixels).
    """
    n_str, n_det = det_centers.shape[:2]
    rel = (det_centers[:, None, :, :]
           - centers.reshape(n_str, -1, 1, 2))                   # [S, T, D, 2]
    u = (rel / torch.clamp_min(win.reshape(n_str, -1, 1, 2), 1e-3) * size
         + size // 2).reshape(-1, n_det, 2)                      # [S*T, D, 2]
    ux = u[..., 0].clamp(0.0, size - 1.0)                        # [S*T, D]
    uy = u[..., 1].clamp(0.0, size - 1.0)
    iota = torch.arange(size, dtype=torch.float32, device=response.device)
    wy = torch.clamp_min(1.0 - torch.abs(uy[..., None] - iota), 0.0)
    wx = torch.clamp_min(1.0 - torch.abs(ux[..., None] - iota), 0.0)
    v = (torch.bmm(wy, response) * wx).sum(dim=-1)               # [S*T, D]
    inside = ((u[..., 0] >= 0) & (u[..., 0] <= size - 1)
              & (u[..., 1] >= 0) & (u[..., 1] <= size - 1))
    return torch.where(inside, v, 0.0).reshape(n_str, -1, n_det)


@functools.lru_cache(maxsize=None)
def _stream_consts(n_str: int, t_cap: int, n_det: int, device: str):
    """Per-stream index tensors, built once per shape and device: each
    track row's stream [S*T] (the gather path's frame index), and the slot
    and detection indices of every stream [S, T], [S, D]."""
    return tuple(x.to(device) for x in (
        torch.arange(n_str).repeat_interleave(t_cap),
        torch.arange(t_cap).repeat(n_str, 1),
        torch.arange(n_det).repeat(n_str, 1)))


def step_streams(bank: TrackBank, frames: torch.Tensor, dets: torch.Tensor,
                 det_valid: torch.Tensor, cfg: TrackerConfig
                 ) -> tuple[TrackBank, StepOutput]:
    """One frame of S streams in one set of launches: returns (new banks,
    outputs), every field with a leading [S].  All tensors on one device.

    bank      : TrackBank whose every field has a leading [S] (kf_mean
                [S, T, 8], kcf.xf [S, T, C, F, Fh], next_id [S], ...).
    frames    : [S, H, W] / [S, H, W, 3] images (uint8 or float).
    dets      : [S, D, 5|6] padded detections; det_valid [S, D] bool.

    Stream s's results are those of `step` on stream s alone (the JAX
    package's jax.vmap(step)).  Per-track math runs on the [S*T] rows,
    stream-major, so one kernel launch serves every stream: the ROI kernels
    read row r's frame r // T of the stacked pyramid, and under the 3-scale
    search the rows fold scale-major [3, S*T], so the fused KCF kernels'
    item i reads model row i % (S*T).  The cost is [S, T, D], the auction
    one batch of S problems, and the lifecycle's cumsums run along each
    stream's slots.
    """
    with span("tracker.step"):
        return _step_streams(bank, frames, dets, det_valid, cfg)


def _step_streams(bank: TrackBank, frames: torch.Tensor, dets: torch.Tensor,
                  det_valid: torch.Tensor, cfg: TrackerConfig
                  ) -> tuple[TrackBank, StepOutput]:
    """step_streams' body, each numbered stage in its span."""
    n_str = frames.shape[0]
    t_cap = cfg.max_tracks
    rows = n_str * t_cap
    n_det = dets.shape[1]
    s = cfg.kcf.feature_size
    dev = frames.device
    frame_hw = tuple(frames.shape[1:3])
    row_stream, slot_iota, det_iota = _stream_consts(n_str, t_cap, n_det,
                                                     str(dev))
    with span("tracker.frames"):
        if _roi_kernel_path(cfg, frames):
            # The level shapes and block-origin clamps come from the
            # config's frame size; a frame that disagrees would sample wrong
            # windows.
            if frame_hw != (cfg.frame_height, cfg.frame_width):
                raise ValueError(
                    f"frame shape {frame_hw} != configured "
                    f"({cfg.frame_height}, {cfg.frame_width}); the ROI "
                    "kernel path requires them to match")
            u8_gray = frames.ndim == 3 and frames.dtype == torch.uint8
            gray = (None if u8_gray
                    else patch_ops.to_gray(frames, batched=True))
            levels = roi.build_pyramid(frames if u8_gray else gray)
        else:
            gray = patch_ops.to_gray(frames, batched=True)
            levels = None

    def per_row(x):
        return x.reshape((rows,) + x.shape[2:])

    def per_stream(x):
        return x.reshape((n_str, t_cap) + x.shape[1:])

    kcf_rows = kcf_ops.KCFModel(*[per_row(x) for x in bank.kcf])
    alive = bank.state > EMPTY                                   # [S, T]
    det_valid = det_valid & (dets[..., 4] >= cfg.det_score_min)
    det_boxes = dets[..., :4]                                    # [S, D, 4]
    det_cls = (torch.round(dets[..., 5]).to(torch.int32)
               if dets.shape[-1] >= 6 else
               torch.zeros((n_str, n_det), dtype=torch.int32, device=dev))

    # ---- 1. Kalman predict -------------------------------------------
    with span("tracker.predict"):
        kf_mean, kf_cov = kalman.predict(per_row(bank.kf_mean),
                                         per_row(bank.kf_cov), cfg.kalman)
        pred_boxes = kf_mean[:, :4]                              # [S*T, 4]

    # ---- 2. KCF detect at predicted ROIs ----------------------------
    with span("tracker.kcf_detect"):
        if cfg.use_kcf:
            # K = 1 scale, or the 3-scale search at 1/step, 1, step; the
            # unit scale is at K // 2.
            scales, scale_vals, scale_wts = kcf_ops.search_scales(
                cfg.kcf.scale_step, cfg.kcf.scale_weight, str(dev))
            unit = len(scales) // 2
            feats = _features_at(gray, pred_boxes, cfg, levels, frame_hw,
                                 row_stream, scales, scale_vals)
            found = kcf_ops.search(kcf_rows, feats, cfg.kcf.kernel_sigma,
                                   scale_wts, cfg.kcf_impl)
            response = found.response[unit]                     # [S*T, S, S]
            peak = found.peak
            if cfg.confidence_mode == "psr":
                # PSR of the unit-scale response (the scale choice itself
                # reads the raw weighted peaks).
                peak = kcf_ops.unit_psr(found)
            wh = pred_boxes[:, 2:4] * scale_vals[found.best][:, None]
            win = wh * cfg.kcf.padding                           # [S*T, 2]
            kcf_cxy = (pred_boxes[:, :2]
                       + torch.stack([found.dx, found.dy], dim=1) * win / s)
            # Trust the correlation only for live slots with a solid peak
            # and an in-frame box (a fully clamped patch self-correlates at
            # ~1).
            h_f, w_f = frame_hw
            in_frame = ((pred_boxes[:, 0] > 0) & (pred_boxes[:, 0] < w_f)
                        & (pred_boxes[:, 1] > 0) & (pred_boxes[:, 1] < h_f))
            kcf_ok = (per_row(alive) & in_frame
                      & (peak >= cfg.confidence_threshold))
            if cfg.train_site == "detect":
                # A slot born last frame (age 1) has no model yet under
                # detect-site training: it coasts on its Kalman prediction.
                kcf_ok = kcf_ok & (per_row(bank.age) != 1)
            refined = torch.where(kcf_ok[:, None],
                                  torch.cat([kcf_cxy, wh], 1), pred_boxes)
        else:
            kcf_ok = torch.zeros((rows,), dtype=torch.bool, device=dev)
            refined = pred_boxes

    # ---- 3. Cost matrix [S, T, D] -------------------------------------
    with span("tracker.cost"):
        appearance = None
        if cfg.use_kcf and cfg.appearance_weight > 0.0:
            appearance = _sample_response(
                response, pred_boxes[:, :2],
                pred_boxes[:, 2:4] * cfg.kcf.padding, det_boxes[..., :2], s)
            if cfg.train_site == "detect":
                # Day-one slots have no model yet (the kcf_ok gate above):
                # zero their rows rather than let stale spectra attract
                # matches.
                appearance = appearance * (bank.age != 1)[..., None]
        # A track only matches detections of its birth class; empty slots
        # (cls < 0, already masked by `alive`) pass.
        class_gate = (((bank.cls[..., :, None] == det_cls[..., None, :])
                       | (bank.cls[..., :, None] < 0)) if cfg.class_aware
                      else None)
        assoc_box = cfg.assoc_box_resolved
        cost = iou_ops.association_cost(
            per_stream(pred_boxes if assoc_box == "predicted" else refined),
            det_boxes, alive, det_valid, cfg.iou_gate, cfg.cost_infeasible,
            appearance=appearance, appearance_weight=cfg.appearance_weight,
            class_gate=class_gate,
            # "best": the Kalman prediction is a second hypothesis per pair.
            track_boxes_alt=(per_stream(pred_boxes) if assoc_box == "best"
                             else None))
        feasible = cost < cfg.cost_infeasible * 0.5

    # ---- 4. Assignment: one batch of S problems ----------------------
    # The warm start carries last frame's prices and matching; the carry is
    # sized for cfg.max_detections, and a caller with another detection
    # padding gets the cold solve.
    with span("tracker.assign"):
        n_sq = max(t_cap, n_det)
        if (cfg.auction_warm_start
                and tuple(bank.auction_prices.shape) == (n_str, n_sq)):
            (matched_det, assign_iters, assign_conv, new_prices,
             new_col_of) = assignment.auction_assign_warm(
                cost, feasible, bank.auction_prices, bank.auction_col_of)
        else:
            matched_det, assign_iters, assign_conv = (
                assignment.auction_assign_stats(
                    cost, feasible, impl=cfg.assign_impl))           # [S, T]
            new_prices = bank.auction_prices
            new_col_of = bank.auction_col_of
        is_matched = matched_det >= 0                                # [S, T]
        det_idx = matched_det.long().clamp(0, n_det - 1)
        # Scatters with JAX's mode="drop" write the dropped entries into
        # one dump column of each stream's row, sliced off after.
        det_taken = torch.zeros((n_str, n_det + 1), dtype=torch.bool,
                                device=dev).scatter_(
            1, torch.where(is_matched, matched_det.long(), n_det),
            True)[:, :n_det]

    def det_rows(x, idx):
        """Per-stream detection field x [S, D(, k)] at idx [S, T]."""
        if x.ndim == 2:
            return x.gather(1, idx)
        return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))

    # ---- 5. Kalman correct -------------------------------------------
    with span("tracker.correct"):
        use_kcf_meas = alive & ~is_matched & per_stream(kcf_ok)
        meas = torch.where(per_row(is_matched)[:, None],
                           per_row(det_rows(det_boxes, det_idx)), refined)
        kf_mean, kf_cov = kalman.correct(kf_mean, kf_cov, meas,
                                         per_row(is_matched | use_kcf_meas),
                                         cfg.kalman)

    # ---- 6/7. Lifecycle, along each stream's slots ---------------------
    with span("tracker.lifecycle"):
        i32 = torch.int32
        hits = torch.where(is_matched, bank.hits + 1, bank.hits)
        tsu = torch.where(is_matched, 0, bank.time_since_update + 1).to(i32)
        age = torch.where(alive, bank.age + 1, 0).to(i32)
        state = bank.state
        state = torch.where((state == TENTATIVE) & (hits >= cfg.n_init),
                            CONFIRMED, state).to(i32)
        die = alive & (((state == CONFIRMED) & (tsu > cfg.max_age))
                       | ((state == TENTATIVE) & ~is_matched
                          & (tsu > cfg.max_age_tentative)))
        n_deaths = die.sum(dim=-1).to(i32)
        state = torch.where(die, EMPTY, state).to(i32)

        # Births: unmatched valid detections -> lowest-index empty slots.
        empty_slots = state == EMPTY
        free_rank = torch.cumsum(empty_slots.long(), -1) - 1         # [S, T]
        slot_of_rank = torch.full((n_str, t_cap + 1), t_cap,
                                  dtype=torch.long, device=dev).scatter_(
            1, torch.where(empty_slots, free_rank, t_cap),
            slot_iota)[:, :t_cap]
        new_det = det_valid & ~det_taken
        birth_rank = torch.cumsum(new_det.long(), -1) - 1            # [S, D]
        n_free = empty_slots.long().sum(dim=-1, keepdim=True)
        can_birth = new_det & (birth_rank < n_free)
        birth_slot = torch.where(
            can_birth,
            slot_of_rank.gather(1, birth_rank.clamp(0, t_cap - 1)),
            t_cap)                                                   # [S, D]
        slot_birth_det = torch.full((n_str, t_cap + 1), -1,
                                    dtype=torch.long, device=dev).scatter_(
            1, birth_slot, det_iota)[:, :t_cap]
        is_birth = slot_birth_det >= 0                               # [S, T]
        n_births = is_birth.sum(dim=-1).to(i32)
        bdet = slot_birth_det.clamp(0, n_det - 1)

        init_mean, init_cov = kalman.init(
            per_row(det_rows(det_boxes, bdet)), cfg.kalman)
        birth_rows = per_row(is_birth)
        kf_mean = torch.where(birth_rows[:, None], init_mean, kf_mean)
        kf_cov = torch.where(birth_rows[:, None, None], init_cov, kf_cov)
        state = torch.where(is_birth, TENTATIVE, state).to(i32)
        hits = torch.where(is_birth, 1, hits).to(i32)
        tsu = torch.where(is_birth, 0, tsu).to(i32)
        age = torch.where(is_birth, 1, age).to(i32)
        new_ids = bank.next_id[:, None] + torch.where(
            is_birth, torch.cumsum(is_birth.long(), -1) - 1, 0)
        ids = torch.where(is_birth, new_ids, bank.ids)
        ids = torch.where(state == EMPTY, -1, ids).to(i32)
        det_score = dets[..., 4]
        score = torch.where(is_birth, det_rows(det_score, bdet), bank.score)
        score = torch.where(is_matched, det_rows(det_score, det_idx), score)
        cls = torch.where(is_birth, det_rows(det_cls, bdet), bank.cls)
        cls = torch.where(state == EMPTY, -1, cls).to(i32)
        next_id = (bank.next_id + n_births).to(i32)

    # ---- 8. KCF training, on the [S*T] rows ----------------------------
    with span("tracker.kcf_train"):
        live = per_row(state > EMPTY)
        if cfg.use_kcf and cfg.train_site == "detect":
            yf = kcf_ops.make_yf(s, cfg.kcf.padding,
                                 cfg.kcf.output_sigma_factor, device=dev)
            # The fused detect consumed raw features: take their spectrum
            # here.
            zf = (found.zf[unit] if found.zf is not None
                  else fft_ops.rfft2(feats[unit]))
            win = torch.clamp_min(pred_boxes[:, 2:4] * cfg.kcf.padding,
                                  1e-6)
            # Feature-pixel displacement of the corrected center from the
            # extraction (predicted) center.
            delta = (kf_mean[:, :2] - pred_boxes[:, :2]) * s / win  # [S*T, 2]
            # Beyond ~S/4 the circular wrap stops being a border effect:
            # skip the EMA update (an init overwrite trains unshifted
            # instead).
            guard = (torch.abs(delta) < s / 4).all(dim=1)
            d_x = torch.where(guard, delta[:, 0], 0.0)
            d_y = torch.where(guard, delta[:, 1], 0.0)
            # First post-birth frame -> full overwrite; births this frame
            # have no sample yet and keep lr = 0.
            fresh = live & ~birth_rows
            init_now = fresh & (per_row(age) == 2)
            lr = torch.where(
                init_now, 1.0,
                torch.where(fresh & guard & (per_row(is_matched) | kcf_ok),
                            cfg.kcf.interp_factor, 0.0))
            # Phase shift, training and blend: K6 in one launch for a gray
            # 64 x 64 bank on the card, the FFT chain otherwise.
            kcf_model = kcf_ops.train_shift_blend_auto(
                kcf_rows, zf, d_y, d_x, yf, cfg.kcf.kernel_sigma,
                cfg.kcf.lambda_, lr, s, cfg.kcf_impl)
        elif cfg.use_kcf:
            # Refined-site training: re-extract at the corrected boxes
            # (births already carry their detection box in kf_mean), through
            # the frame's one pyramid on the kernel path.
            lr = torch.where(
                birth_rows, 1.0,
                torch.where(live & (per_row(is_matched) | kcf_ok),
                            cfg.kcf.interp_factor, 0.0))
            feats_new = _features_at(gray, kf_mean[:, :4], cfg, levels,
                                     frame_hw, row_stream)[0]
            yf = kcf_ops.make_yf(s, cfg.kcf.padding,
                                 cfg.kcf.output_sigma_factor, device=dev)
            kcf_model = kcf_ops.train_blend_auto(
                kcf_rows, feats_new, yf, cfg.kcf.kernel_sigma,
                cfg.kcf.lambda_, lr, cfg.kcf_impl)
        else:
            kcf_model = kcf_rows

    kf_mean = per_stream(kf_mean)
    new_bank = TrackBank(
        kf_mean=kf_mean, kf_cov=per_stream(kf_cov),
        kcf=kcf_ops.KCFModel(*[per_stream(x) for x in kcf_model]), ids=ids,
        state=state, hits=hits, time_since_update=tsu, age=age,
        score=score, cls=cls, auction_prices=new_prices,
        auction_col_of=new_col_of, next_id=next_id,
        frame_idx=(bank.frame_idx + 1).to(i32))

    out = StepOutput(
        ids=ids,
        boxes=kf_mean[..., :4],
        scores=score,
        valid=(state == CONFIRMED) & (tsu <= cfg.output_max_tsu),
        matched_det=matched_det,
        cls=cls,
        n_alive=(state > EMPTY).sum(dim=-1).to(i32),
        n_births=n_births,
        n_deaths=n_deaths,
        n_matches=is_matched.sum(dim=-1).to(i32),
        assign_iters=assign_iters,
        assign_converged=assign_conv,
    )
    return new_bank, out


def step(bank: TrackBank, frame: torch.Tensor, dets: torch.Tensor,
         det_valid: torch.Tensor, cfg: TrackerConfig
         ) -> tuple[TrackBank, StepOutput]:
    """One frame: returns (new bank, outputs).  All tensors on one device.

    frame     : [H, W] / [H, W, 3] image (uint8 or float).
    dets      : [D, 5] (cx, cy, w, h, score), or [D, 6] with a class id in
                column 5, padded to a static D.
    det_valid : [D] bool for real detections.

    `step_streams` at S = 1: the same launches, the same results.
    """
    new_bank, out = step_streams(bank_mod.map_bank(lambda x: x[None], bank),
                                 frame[None], dets[None], det_valid[None],
                                 cfg)
    return (bank_mod.map_bank(lambda x: x[0], new_bank),
            StepOutput(*[x[0] for x in out]))


def init(frame: torch.Tensor, dets: torch.Tensor, det_valid: torch.Tensor,
         cfg: TrackerConfig) -> tuple[TrackBank, StepOutput]:
    """A bank from the first frame's detections: every valid detection
    births a track."""
    return step(bank_mod.empty_bank(cfg, device=frame.device), frame, dets,
                det_valid, cfg)
