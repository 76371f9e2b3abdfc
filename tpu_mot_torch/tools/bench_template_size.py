"""The port's twin of the repo's `tools/bench_template_size.py`: the
template-size serving knob, frames/s against MOTA and HOTA on the bench
fixture, on the CUDA card.

    python -m tpu_mot_torch.tools.bench_template_size [--samples 7]
    python -m tpu_mot_torch.tools.bench_template_size --device cpu --small

The rows are `tools/bench_template_size.py:51-54`'s,
`KCFConfig(template_size=s)` for s in (64, 48, 32), on `bench.py`'s load
(1080p, 128 objects, 64 frames, 160 detection slots, 128 tracks).  s = 64
is the default configuration; at 48 and 32 K1 resamples each window to a
48x48 or 32x32 tile (it reads S at run time) and the FFT chain runs at
that size (48 is no power of two).

Each row runs `tools/bench.py`'s protocol: a warm-up run from an empty
bank, scored against the ground truth (MOTA by `utils/metrics.clear_mot`,
HOTA by `utils/metrics.hota`), then `--samples` dependent runs ended by a
synchronise and one small fetch; `fps` is the frames over the median run.
One JSON line a row with the JAX tool's keys (template_size, fps,
ms_per_frame, mota, hota) plus metric, spread_fps, n_samples and device
(the card's name and power limit).  `--small` is `tools/bench.py`'s and is
refused on the card.
"""

from __future__ import annotations

from tpu_mot_torch.config import KCFConfig
from tpu_mot_torch.tools import bench

SIZES = (64, 48, 32)


def rows(fx: bench.Fixture) -> list[bench.Row]:
    return [bench.Row(s, fx.config(kcf=KCFConfig(template_size=s)))
            for s in SIZES]


def line(fx: bench.Fixture, row: bench.Row, out, secs: list[float]
         ) -> dict:
    sc = bench.scores(out, fx)
    return {"template_size": row.key, **bench.rates(len(fx.frames), secs),
            "mota": round(float(sc["mota"]), 4),
            "hota": round(float(sc["hota"]), 4)}


def main(argv=None) -> tuple[list[dict], dict]:
    """Print one JSON line a template size; returns (the lines, {size: the
    warm-up run's StepOutput})."""
    return bench.table_main(argv, __doc__, rows, line)


if __name__ == "__main__":
    main()
