"""The port's twin of the repo's `tools/bench_class_cost.py`: what
class-aware association costs at the bench shape (1080p, 128 tracks, 160
detection slots), on the CUDA card.

    python -m tpu_mot_torch.tools.bench_class_cost [--samples 7]
    python -m tpu_mot_torch.tools.bench_class_cost --device cpu --small

Two rows on `bench.py`'s load (`tools/bench_class_cost.py:40-64`):
`class_aware=False` fed 5-column detections, and `class_aware=True` fed the
same detections as 6 columns, every one of class 0
(`pad_detections(..., width=6)`).  Class-aware association adds the class
gate (a [T, D] equality mask folded into feasibility) and, with
`assoc_box` "auto" resolved to "best", the dual-hypothesis cost: a second
IoU of the Kalman boxes and a per-pair max.  The JAX tool's docstring
(`:8-11`) says the class-aware run then makes the class-blind run's
decisions exactly; the "best" cost scores a pair by the better of two
boxes, so that is a claim to check (PERF.md §6 has the answer on the
bench fixture).

Each row runs `tools/bench.py`'s protocol: a warm-up run from an empty
bank, then `--samples` dependent runs ended by a synchronise and one small
fetch; `fps` is the frames over the median run.  One JSON line a row with
the JAX tool's keys (class_aware, assoc_box_resolved, fps, ms_per_frame)
plus metric, spread_fps, n_samples and device (the card's name and power
limit).  `--small` is `tools/bench.py`'s and is refused on the card.
"""

from __future__ import annotations

import numpy as np

from tpu_mot_torch.tools import bench
from tpu_mot_torch.tracker.api import pad_detections

ROWS = (False, True)


def detections(fx: bench.Fixture, class_aware: bool):
    """The fixture's padded detections: 5 columns, or 6 with class 0."""
    if not class_aware:
        return fx.dets, fx.valid
    d = np.zeros(fx.dets.shape[:2] + (6,), np.float32)
    v = np.zeros(fx.valid.shape, bool)
    for f, dets in enumerate(fx.dets_list):
        d[f], v[f] = pad_detections(dets, fx.dets.shape[1], width=6)
    return d, v


def rows(fx: bench.Fixture) -> list[bench.Row]:
    return [bench.Row(c, fx.config(class_aware=c), detections(fx, c))
            for c in ROWS]


def line(fx: bench.Fixture, row: bench.Row, out, secs: list[float]
         ) -> dict:
    return {"class_aware": row.key,
            "assoc_box_resolved": row.config.assoc_box_resolved,
            **bench.rates(len(fx.frames), secs)}


def main(argv=None) -> tuple[list[dict], dict]:
    """Print one JSON line a row; returns (the lines, {class_aware: the
    warm-up run's StepOutput})."""
    return bench.table_main(argv, __doc__, rows, line)


if __name__ == "__main__":
    main()
