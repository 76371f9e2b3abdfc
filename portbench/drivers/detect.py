"""Detect -> track serving: yolov3-tiny over every stream's frame in one
batch, then every stream's tracker on its own detections, one frame of
every stream a call through
`tpu_mot_torch.parallel.serve.detect_then_track_step_shared` (mesh None:
one forward over all streams).

The traffic file has the tracker-only driver's keys (drivers/serve.py).
The configuration's `detector` block gives the net (`name`,
`num_classes`, `input_size`) and the NMS settings; its weights are made on
the device from the seed (`weights`) and handed to the program and the
reference alike.

Correctness: the detections of the checked calls (kept as the detector
hands them to the tracker) against the reference detector's, matched per
frame as sets; then the reference tracker on the reference detector's
detections against the program's tracks and state, as in the tracker-only
driver (the warm-up calls from the reference's own empty state, the
window's sample from the program's state before each call).
"""

from __future__ import annotations

import math

import torch
from torch.autograd.profiler import record_function

from portbench import gen
from portbench.drivers import serve as base
from portbench.reference import tracker as ref
from portbench.reference import yolo as yref
from portbench.tracing import CALL, FETCH


def weights(names_shapes, seed: int, device) -> dict:
    """Seeded yolov3-tiny weights in the program's state-dict layout, from
    one generator on the device in one draw: He-scaled conv kernels, linear
    heads scaled so their logits are about N(0, 1), BatchNorm scale
    exp(0.1 n), shift, running mean 0.1 n, running variance exp(0.1 n)."""
    gen_ = torch.Generator(device=device)
    gen_.manual_seed(gen.stream_seed(seed, -1))
    sizes = [math.prod(s) for _, s in names_shapes]
    draw = torch.randn((sum(sizes),), generator=gen_, device=device)
    out, pos = {}, 0
    for (name, shape), n in zip(names_shapes, sizes):
        x = draw[pos:pos + n].reshape(shape)
        pos += n
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        if name.endswith("conv.weight"):
            fan_in = math.prod(shape[1:])
            head = name.startswith("head")
            x = x * ((1.0 if head else math.sqrt(2.0)) / math.sqrt(fan_in))
        elif name.endswith(("bn.weight", "bn.running_var")):
            x = torch.exp(0.1 * x)
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def match_sets(pd, pv, pc, rd, rv, rc, match_px: float):
    """Per frame, each program detection against the reference detection
    of its class nearest in box: (unmatched on either side, widest box gap
    of a match in px, widest score gap of a match)."""
    unmatched, box_gap, score_gap = 0, 0.0, 0.0
    for b in range(pd.shape[0]):
        p_idx = torch.nonzero(pv[b])[:, 0]
        r_idx = torch.nonzero(rv[b])[:, 0]
        if len(p_idx) == 0 or len(r_idx) == 0:
            unmatched += len(p_idx) + len(r_idx)
            continue
        gap = (pd[b, p_idx, None, :4] - rd[b, None, r_idx, :4]).abs().amax(-1)
        gap = torch.where(pc[b, p_idx, None] == rc[b, None, r_idx], gap,
                          float("inf"))
        best, j = gap.min(dim=1)
        ok = best <= match_px
        n_ok = int(ok.sum())
        used = len(torch.unique(j[ok]))
        unmatched += (len(p_idx) - n_ok) + (len(r_idx) - used) + (n_ok - used)
        if n_ok:
            box_gap = max(box_gap, float(best[ok].max()))
            s_gap = (pd[b, p_idx[ok], 4] - rd[b, r_idx[j[ok]], 4]).abs().max()
            score_gap = max(score_gap, float(s_gap))
    return unmatched, box_gap, score_gap


class Driver(base.Driver):
    """Detect -> track cells."""

    def setup(self):
        from tpu_mot_torch.models.detector import YoloDetector, detect_batch
        from tpu_mot_torch.models.yolo import YoloSpec, build_model
        from tpu_mot_torch.parallel import serve

        tr, dc = self.tr, self.conf["detector"]
        self.h, self.w = int(tr["height"]), int(tr["width"])
        self.cfg = base.tracker_config(self.conf["tracker"], self.h, self.w)
        self.frames = gen.render(
            self.seed, self.n_streams, int(tr["clip_frames"]), self.h,
            self.w, int(tr["objects"]), int(tr["min_size"]),
            int(tr["max_size"]), float(tr["max_speed"]), float(tr["noise"]),
            int(tr["objects"]), self.device).frames
        spec = YoloSpec(dc["name"], num_classes=int(dc["num_classes"]),
                        input_size=int(dc["input_size"]))
        with torch.device("meta"):
            shapes = [(k, tuple(v.shape))
                      for k, v in build_model(spec).state_dict().items()]
        self.params = weights(shapes, self.seed, self.device)
        self.model = YoloDetector(spec, self.params,
                                  device=self.device).model
        hw = (self.h, self.w)
        max_out = int(dc["max_out"])
        iou_thr, score_thr = float(dc["iou_thr"]), float(dc["score_thr"])

        def detect_fn(model, fr):
            out = detect_batch(model, fr, hw, max_out, iou_thr, score_thr)
            self._dets = out
            return out

        self.detect_fn = detect_fn
        self.serve = serve
        self.banks = serve.make_stream_banks(self.n_streams, self.cfg,
                                             device=self.device)
        self.step_i = 0
        outs = []
        for _ in range(int(tr.get("warmup_calls", 3))):
            self.call(None)
            outs.append((self.last, self._dets))
        self.start = (outs, self.banks)

    def input_bytes(self) -> int:
        """Bytes of the clips' frames on the device."""
        return self.frames.numel() * self.frames.element_size()

    def call(self, slot):
        f = gen.replay_index(self.step_i, self.frames.shape[0])
        before = self.banks
        with record_function(CALL):
            banks, out = self.serve.detect_then_track_step_shared(
                self.model, before, self.frames[f], self.cfg, self.detect_fn)
        with record_function(FETCH):
            self.last = (out.ids.cpu(), out.boxes.cpu(), out.valid.cpu())
        self.banks = banks
        self.step_i += 1
        if slot is not None:
            self.held[slot] = (f, before, banks, (self.last, self._dets))
        return self.n_streams

    def trace_facts(self) -> dict:
        facts = super().trace_facts()
        facts["step_flops_per_call"] = self.n_streams * yolo_flops(
            self.params, int(self.conf["detector"]["input_size"]))
        return facts

    def release(self):
        self.model = None
        self._dets = None
        super().release()

    # -- correctness ---------------------------------------------------
    def check(self, subject: str = "program") -> dict:
        """As the tracker-only driver's check, with the detections first.
        The reference tracker follows the reference detector's
        detections; the program's tracker followed the program's, and the
        control's (subject="control") follows the TF32 reference
        detector's."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        control = subject == "control"
        p = ref.params_from_config(self.conf["tracker"], (self.h, self.w))
        lim = self.conf["limits"]
        gaps = base.Gaps(lim)
        det_unmatched, det_total, det_box, det_score = 0, 0, 0.0, 0.0
        block = base.CHECK_BLOCK_STREAMS
        max_out = int(self.conf["detector"]["max_out"])
        size = int(self.conf["detector"]["input_size"])

        def detections(frames, program_dets):
            """(the reference's detections, the subject's), compared."""
            nonlocal det_unmatched, det_total, det_box, det_score
            r = yref.detect(self.params, frames, (self.h, self.w), max_out,
                            size=size)
            got = (yref.detect(self.params, frames, (self.h, self.w),
                               max_out, precision="tf32", size=size)
                   if control else program_dets)
            u, bg, sg = match_sets(got[0], got[1], got[2], r[0], r[1], r[2],
                                   float(lim["det_match_px"]))
            det_unmatched += u
            det_total += int(got[1].sum()) + int(r[1].sum())
            det_box = max(det_box, bg)
            det_score = max(det_score, sg)
            return r, got

        def track(st0, steps, after):
            """Follow the steps (frames, reference's detections, subject's
            detections, tracks on the host) from st0 per block of streams;
            compare each step's tracks and the state left."""
            for lo in range(0, self.n_streams, block):
                sl = slice(lo, min(lo + block, self.n_streams))
                st = ctl = base.state_block(st0, sl)
                for fr, rd, sd, host in steps:
                    st, r = ref.step(st, fr[sl], rd[0][sl], rd[1][sl], p)
                    if control:
                        ctl, c = ref.step(ctl, fr[sl], sd[0][sl], sd[1][sl],
                                          p, precision="tf32")
                        gaps.outputs(c.ids, c.boxes, c.valid, r)
                    else:
                        gaps.outputs(*(x[sl] for x in host), r)
                gaps.state(ctl if control else base.state_block(after, sl),
                           st, p)

        with torch.no_grad():
            outs, bank = self.start
            steps = []
            for i, (host, dets) in enumerate(outs):
                fr = self.frames[gen.replay_index(i, self.frames.shape[0])]
                steps.append((fr, *detections(fr, dets), host))
            track(ref.empty_state(p, self.n_streams, self.device), steps,
                  base.to_ref_state(bank))
            for f, before, after, (host, dets) in self.held.values():
                fr = self.frames[f]
                track(base.to_ref_state(before),
                      [(fr, *detections(fr, dets), host)],
                      base.to_ref_state(after))
        checks = gaps.as_checks(lim)
        for k, v in (("det_mismatch_share",
                      det_unmatched / max(det_total, 1)),
                     ("det_box_gap_px", det_box),
                     ("det_score_gap", det_score)):
            checks[k] = {"value": v, "limit": lim[k]}
        return checks


def yolo_flops(params: dict, size: int) -> float:
    """Multiply-adds x 2 of yolov3-tiny's convolutions on one gray image at
    `size`, from the layer shapes (the first conv reads one channel)."""
    grid = {0: size, 1: size // 2, 2: size // 4, 3: size // 8,
            4: size // 16, 5: size // 32, 6: size // 32, 7: size // 32,
            8: size // 32, 9: size // 32, 10: size // 16}
    total = 0.0
    for name, w in params.items():
        if not name.endswith("conv.weight"):
            continue
        blk = name.split(".")[0]
        if blk == "head0":
            g = size // 32
        elif blk == "head1":
            g = size // 16
        else:
            g = grid[int(blk.split("_")[1])]
        co, ci, kh, kw = w.shape
        if blk == "ConvBlock_0":
            ci = 1
        total += 2.0 * co * ci * kh * kw * g * g
    return total
