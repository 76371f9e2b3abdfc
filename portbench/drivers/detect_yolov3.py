"""Detect -> track serving with full YOLOv3 (darknet-53, three heads) in
front of the tracker: the detector of `drivers/detect.py`'s cells
replaced by the configuration's `yolov3`, the same serving call
(`parallel.serve.detect_then_track_step_shared`, one forward over every
stream's frame), the same traffic keys.

Weights: drawn as `drivers/detect.weights` draws them, then every
BatchNorm's running statistics set to its conv output's over the first
frame of up to 8 streams (`reference/yolov3.calibrate`), as training
leaves them.  With the drawn statistics the 23 shortcut adds grow the
activations about 2x in variance each and every score saturates.

Correctness: `drivers/detect.py`'s comparison, with `reference/yolov3`
as the reference detector (run `CHECK_BLOCK_FRAMES` frames at a time, so
that it fits beside the state the check holds).
"""

from __future__ import annotations

import sys

import torch

from portbench import gen
from portbench.drivers import detect
from portbench.drivers import serve as base
from portbench.reference import tracker as ref
from portbench.reference import yolov3 as yref

CHECK_BLOCK_FRAMES = 32
CALIBRATION_STREAMS = 8


def program_counters() -> dict:
    """The program's counters of detector work, where it has them."""
    from tpu_mot_torch.models import detector, yolo

    out = {}
    for key, mod, name in (("candidates", detector, "candidates"),
                           ("shortcuts", yolo, "shortcuts")):
        if isinstance(getattr(mod, name, None), int):
            out[key] = getattr(mod, name)
    return out


class Driver(detect.Driver):
    """Detect -> track cells with YOLOv3."""

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
        self.size = int(dc["input_size"])
        spec = YoloSpec(dc["name"], num_classes=int(dc["num_classes"]),
                        input_size=self.size)
        with torch.device("meta"):
            shapes = [(k, tuple(v.shape))
                      for k, v in build_model(spec).state_dict().items()]
        self.params = yref.calibrate(
            detect.weights(shapes, self.seed, self.device),
            self.frames[0, :CALIBRATION_STREAMS], self.size)
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

    # -- traced-run facts -----------------------------------------------
    def before_trace(self):
        super().before_trace()
        self._counted = (self.step_i, program_counters())

    def after_trace(self):
        super().after_trace()
        step0, before = self._counted
        calls = self.step_i - step0
        after = program_counters()
        self._per_call = {f"{k}_per_call": (after[k] - before[k]) / calls
                          for k in after if k in before and calls}
        if self._per_call:
            print(f"portbench: program counters a call {self._per_call}",
                  file=sys.stderr)

    def trace_facts(self) -> dict:
        facts = base.Driver.trace_facts(self)
        flops = self.n_streams * yref.conv_flops(self.size, gray=True)
        facts["step_flops_per_call"] = flops
        facts["conv_flops_per_call"] = flops
        facts.update(getattr(self, "_per_call", {}))
        return facts

    # -- correctness ----------------------------------------------------
    def check(self, subject: str = "program") -> dict:
        """`drivers/detect.py`'s check with `reference/yolov3` as the
        reference detector."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        control = subject == "control"
        p = ref.params_from_config(self.conf["tracker"], (self.h, self.w))
        lim = self.conf["limits"]
        gaps = base.Gaps(lim)
        det_unmatched, det_total, det_box, det_score = 0, 0, 0.0, 0.0
        block = base.CHECK_BLOCK_STREAMS
        max_out = int(self.conf["detector"]["max_out"])
        hw = (self.h, self.w)

        def detections(frames, program_dets):
            """(the reference's detections, the subject's), compared."""
            nonlocal det_unmatched, det_total, det_box, det_score
            r = yref.detect(self.params, frames, hw, max_out,
                            size=self.size, block=CHECK_BLOCK_FRAMES)
            got = (yref.detect(self.params, frames, hw, max_out,
                               precision="tf32", size=self.size,
                               block=CHECK_BLOCK_FRAMES)
                   if control else program_dets)
            u, bg, sg = detect.match_sets(got[0], got[1], got[2], r[0],
                                          r[1], r[2],
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
