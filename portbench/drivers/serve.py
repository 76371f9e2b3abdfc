"""Tracker-only serving: every stream advances one frame per call, through
`tpu_mot_torch.parallel.serve.multi_stream_step` (one set of launches over
all streams' tracks), and the call's tracks (ids, boxes, valid) are
fetched to the host.

The traffic file gives the generator's parameters (`streams`,
`clip_frames`, `height`, `width`, `objects`, `min_size`, `max_size`,
`max_speed`, `noise`) and the number of warm-up calls; the configuration
file gives the tracker's settings (`tracker`, the keyword arguments of
`TrackerConfig`, with `kcf` and `kalman` as dicts) and the limits of the
comparison.  A clip is replayed forwards, then backwards (0..N-1, N-2..1,
0, ...), so the tracks reach a steady state.

Correctness: the warm-up calls from an empty bank are followed by the
reference from its own empty state; each call of the window's sample is
followed from the program's state before it (the tracker is a feedback
loop that amplifies last-bit differences over many frames, so it is
checked a step at a time).  Both compare every stream's tracks and the
state the call leaves.
"""

from __future__ import annotations

import torch
from torch.autograd.profiler import record_function

from portbench import gen
from portbench.reference import tracker as ref
from portbench.tracing import CALL, FETCH

# Streams the reference steps at once in the check (all 256 of a cell's).
CHECK_BLOCK_STREAMS = 256


def tracker_config(conf: dict, height: int, width: int):
    from tpu_mot_torch.config import KalmanConfig, KCFConfig, TrackerConfig

    kw = dict(conf)
    kcf = KCFConfig(**kw.pop("kcf", {}))
    kal = KalmanConfig(**kw.pop("kalman", {}))
    return TrackerConfig(kcf=kcf, kalman=kal, frame_height=height,
                         frame_width=width, **kw)


def to_ref_state(bank) -> ref.State:
    """The program's bank, read into the reference's state (field by
    field; nothing of the program is called)."""
    return ref.State(kf_mean=bank.kf_mean, kf_cov=bank.kf_cov,
                     xf=bank.kcf.xf, alphaf=bank.kcf.alphaf, ids=bank.ids,
                     state=bank.state, hits=bank.hits,
                     tsu=bank.time_since_update, age=bank.age,
                     score=bank.score, next_id=bank.next_id)


def state_block(st: ref.State, sl: slice) -> ref.State:
    """Streams `sl` of a reference state."""
    return ref.State(*[x[sl] for x in st])


class Gaps:
    """The numbers the comparison reports, accumulated over blocks.

    A track output (a stream's slot at a checked step) disagrees when its
    id or its valid flag differs from the reference's, or, valid in both,
    when its box differs by more than `box_rel_tol` of its size.  A slot's
    state disagrees when a lifecycle integer differs, when its Kalman
    state differs by more than `box_rel_tol` of its size, or when its KCF
    model differs: its template spectrum by more than `xf_rel_tol`, or
    the response it gives on the reference's template by more than
    `resp_rel_tol`, each of the row's largest magnitude.  The numbers are
    the shares that disagree."""

    def __init__(self, limits: dict):
        self.tol_box = float(limits["box_rel_tol"])
        self.tol_xf = float(limits["xf_rel_tol"])
        self.tol_resp = float(limits["resp_rel_tol"])
        self.out_bad = self.out_n = 0
        self.state_bad = self.state_n = 0

    def outputs(self, ids, boxes, valid, r: ref.Out):
        """Tracks as the consumer got them against the reference's."""
        ids, boxes, valid = (x.to(r.ids.device) for x in (ids, boxes, valid))
        scale = r.boxes[..., 2:4].abs().amax(dim=-1).clamp_min(1.0)
        rel = (boxes - r.boxes).abs().amax(dim=-1) / scale
        both = valid & r.valid
        bad = ((ids != r.ids) | (valid != r.valid)
               | (both & (rel > self.tol_box)))
        self.out_bad += int(bad.sum())
        self.out_n += bad.numel()

    def state(self, p: ref.State, r: ref.State, params: ref.Params):
        """The state a call leaves against the reference's, slot by slot."""
        bad = torch.zeros_like(r.state, dtype=torch.bool)
        for a, b in ((p.ids, r.ids), (p.state, r.state), (p.hits, r.hits),
                     (p.tsu, r.tsu), (p.age, r.age)):
            bad |= a != b
        bad |= (p.next_id != r.next_id)[:, None]
        live = (p.state > 0) & (r.state > 0)
        scale = r.kf_mean[..., 2:4].abs().amax(dim=-1).clamp_min(1.0)
        kf = (p.kf_mean - r.kf_mean).abs().amax(dim=-1) / scale

        def rel(a, b):
            dims = tuple(range(2, b.ndim))
            return ((a - b).abs().amax(dim=dims)
                    / b.abs().amax(dim=dims).clamp_min(1e-30))

        xf = rel(p.xf, r.xf)
        resp = rel(ref.model_response(r.xf, p.alphaf, params),
                   ref.model_response(r.xf, r.alphaf, params))
        bad |= live & ((kf > self.tol_box) | (xf > self.tol_xf)
                       | (resp > self.tol_resp))
        self.state_bad += int(bad.sum())
        self.state_n += bad.numel()

    def as_checks(self, limits: dict) -> dict:
        return {
            "track_mismatch_share": {
                "value": self.out_bad / max(self.out_n, 1),
                "limit": limits["track_mismatch_share"]},
            "state_mismatch_share": {
                "value": self.state_bad / max(self.state_n, 1),
                "limit": limits["state_mismatch_share"]}}


class Driver:
    """One cell's program, inputs and serving calls."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.conf = config
        self.tr = traffic
        self.seed = seed
        self.device = device
        self.n_streams = int(traffic["streams"])
        self.held = {}
        self.start = None

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from tpu_mot_torch.parallel import serve

        tr = self.tr
        self.h, self.w = int(tr["height"]), int(tr["width"])
        self.cfg = tracker_config(self.conf["tracker"], self.h, self.w)
        self.clips = gen.render(
            self.seed, self.n_streams, int(tr["clip_frames"]), self.h,
            self.w, int(tr["objects"]), int(tr["min_size"]),
            int(tr["max_size"]), float(tr["max_speed"]), float(tr["noise"]),
            self.cfg.max_detections, self.device)
        self.serve = serve
        self.banks = serve.make_stream_banks(self.n_streams, self.cfg,
                                             device=self.device)
        self.step_i = 0
        outs = []
        for _ in range(int(tr.get("warmup_calls", 3))):
            self.call(None)
            outs.append(self.last)
        self.start = (outs, self.banks)

    def input_bytes(self) -> int:
        """Bytes of the clips' frames on the device."""
        f = self.clips.frames
        return f.numel() * f.element_size()

    def _frame(self, i):
        f = gen.replay_index(i, self.clips.frames.shape[0])
        return f, self.clips.frames[f], self.clips.dets[f], self.clips.valid[f]

    # -- serving --------------------------------------------------------------
    def call(self, slot):
        """One serving call: every stream's next frame, tracks fetched.
        `slot` not None keeps the call's state for the check."""
        f, frames, dets, valid = self._frame(self.step_i)
        before = self.banks
        with record_function(CALL):
            banks, out = self.serve.multi_stream_step(before, frames, dets,
                                                      valid, self.cfg)
        with record_function(FETCH):
            self.last = (out.ids.cpu(), out.boxes.cpu(), out.valid.cpu())
        self.banks = banks
        self.step_i += 1
        if slot is not None:
            self.held[slot] = (f, before, banks, self.last)
        return self.n_streams

    # -- traced-run facts -----------------------------------------------------
    def _k1_bytes(self):
        """Bytes K1 needs a call: each output patch written once, each
        level pixel the windows cover read once, and the per-row sample
        coordinates read once; from the bank's predicted boxes."""
        m = self.banks.kf_mean
        box = m[..., :4] + m[..., 4:]
        wh = box[..., 2:4].clamp_min(1.0) * self.cfg.kcf.padding
        win = wh.amax(dim=-1)
        lvl = torch.clamp(torch.ceil(torch.log2(
            torch.clamp_min(win / 128.0, 1.0))), 0, 3)
        scale = torch.exp2(lvl)
        lh = torch.ceil(self.h / scale)
        lw = torch.ceil(self.w / scale)
        px = (torch.minimum(wh[..., 1] / scale, lh)
              * torch.minimum(wh[..., 0] / scale, lw))
        s = self.cfg.kcf.template_size
        rows = m.shape[0] * m.shape[1]
        return float(px.sum()) + rows * (s * s * 4 + 3 * 4 + 2 * s * 4)

    def before_trace(self):
        self._k1 = [self._k1_bytes()]

    def after_trace(self):
        self._k1.append(self._k1_bytes())

    def trace_facts(self) -> dict:
        n = max(self.cfg.max_tracks, self.cfg.max_detections)
        return {"k1_bytes_per_call": sum(self._k1) / len(self._k1),
                "k2_bytes_per_call": self.n_streams * (n * n * 4 + n * 4 + 4)}

    # -- correctness ----------------------------------------------------------
    def release(self):
        """Free the program's state but what the check holds."""
        self.banks = None
        self.last = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, subject: str = "program") -> dict:
        """Compare the warm-up calls and the window's sample with the
        reference.  subject="control": the reference in TF32 takes the
        program's place (it has to fail)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p = ref.params_from_config(self.conf["tracker"], (self.h, self.w))
        gaps = Gaps(self.conf["limits"])
        block = CHECK_BLOCK_STREAMS
        outs, bank = self.start
        with torch.no_grad():
            for lo in range(0, self.n_streams, block):
                sl = slice(lo, min(lo + block, self.n_streams))
                n = sl.stop - sl.start
                st = ref.empty_state(p, n, self.device)
                ctl = st
                for i, out in enumerate(outs):
                    _, frames, dets, valid = self._frame(i)
                    args = (frames[sl], dets[sl], valid[sl], p)
                    st, r = ref.step(st, *args)
                    if subject == "control":
                        ctl, c = ref.step(ctl, *args, precision="tf32")
                        gaps.outputs(c.ids, c.boxes, c.valid, r)
                    else:
                        gaps.outputs(*(x[sl] for x in out), r)
                gaps.state(ctl if subject == "control"
                           else state_block(to_ref_state(bank), sl), st, p)
            for f, before, after, out in self.held.values():
                frames = self.clips.frames[f]
                dets = self.clips.dets[f]
                valid = self.clips.valid[f]
                b_st, a_st = to_ref_state(before), to_ref_state(after)
                for lo in range(0, self.n_streams, block):
                    sl = slice(lo, min(lo + block, self.n_streams))
                    args = (state_block(b_st, sl), frames[sl], dets[sl],
                            valid[sl], p)
                    st, r = ref.step(*args)
                    if subject == "control":
                        a, c = ref.step(*args, precision="tf32")
                        gaps.outputs(c.ids, c.boxes, c.valid, r)
                    else:
                        a = state_block(a_st, sl)
                        gaps.outputs(*(x[sl] for x in out), r)
                    gaps.state(a, st, p)
        return gaps.as_checks(self.conf["limits"])
