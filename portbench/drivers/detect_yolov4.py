"""Detect -> track serving with full YOLOv4 (CSPDarknet53 with Mish, SPP,
PANet, grid-sensitive heads) in front of the tracker: `detect_yolov3`'s
driver with the configuration's `yolov4` and `reference/yolov4` in place
of `reference/yolov3`; the same serving call
(`parallel.serve.detect_then_track_step_shared`, one forward over every
stream's frame), the same traffic keys.

Weights: drawn as `drivers/detect.weights` draws them, then every
BatchNorm's running statistics set to its conv output's over the first
frame of up to 8 streams, in cfg order (`reference/yolov4.calibrate`).

Correctness: `drivers/detect.py`'s comparison, with `reference/yolov4`
as the reference detector (run `CHECK_BLOCK_FRAMES` frames at a time).

Traced runs add the bytes of the BatchNorm epilogues a call at their bound
(`epilogue_bytes_per_call`, from the reference's conv list) and the
program's Mish epilogue launches a call, where it counts them.
"""

from __future__ import annotations

import sys

import torch

from portbench import gen
from portbench.drivers import detect, detect_yolov3
from portbench.drivers import serve as base
from portbench.reference import tracker as ref
from portbench.reference import yolov4 as yref

CHECK_BLOCK_FRAMES = detect_yolov3.CHECK_BLOCK_FRAMES
CALIBRATION_STREAMS = detect_yolov3.CALIBRATION_STREAMS


def mish_launches() -> int | None:
    """The program's count of Mish epilogue launches, where it has one."""
    from tpu_mot_torch.models import epilogue

    n = getattr(epilogue, "mish_launches", None)
    return n if isinstance(n, int) else None


class Driver(detect_yolov3.Driver):
    """Detect -> track cells with YOLOv4."""

    def setup(self):
        from tpu_mot_torch.models.detector import YoloDetector, detect_batch
        from tpu_mot_torch.models.yolo import YoloSpec, build_model
        from tpu_mot_torch.parallel import serve

        tr, dc = self.tr, self.conf["detector"]
        # the spec first: a program without the net stops here, at once
        self.size = int(dc["input_size"])
        spec = YoloSpec(dc["name"], num_classes=int(dc["num_classes"]),
                        input_size=self.size)
        self.h, self.w = int(tr["height"]), int(tr["width"])
        self.cfg = base.tracker_config(self.conf["tracker"], self.h, self.w)
        self.frames = gen.render(
            self.seed, self.n_streams, int(tr["clip_frames"]), self.h,
            self.w, int(tr["objects"]), int(tr["min_size"]),
            int(tr["max_size"]), float(tr["max_speed"]), float(tr["noise"]),
            int(tr["objects"]), self.device).frames
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
        self._mish = mish_launches()

    def after_trace(self):
        super().after_trace()
        calls = self.step_i - self._counted[0]
        after = mish_launches()
        if calls and after is not None and self._mish is not None:
            self._per_call["mish_launches_per_call"] = (
                (after - self._mish) / calls)
            print(f"portbench: Mish epilogue launches a call "
                  f"{self._per_call['mish_launches_per_call']}",
                  file=sys.stderr)

    def trace_facts(self) -> dict:
        facts = base.Driver.trace_facts(self)
        flops = self.n_streams * yref.conv_flops(self.size, gray=True)
        facts["step_flops_per_call"] = flops
        facts["conv_flops_per_call"] = flops
        facts["epilogue_bytes_per_call"] = (self.n_streams
                                            * yref.epilogue_bytes(self.size))
        facts.update(getattr(self, "_per_call", {}))
        return facts

    # -- correctness ----------------------------------------------------
    def check(self, subject: str = "program") -> dict:
        """`drivers/detect.py`'s check with `reference/yolov4` as the
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
