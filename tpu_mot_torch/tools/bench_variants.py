"""The port's twin of the repo's `tools/bench_variants.py`: the tracker's
expensive variants (fHOG-31 features, the 3-scale search, peak-vs-PSR
confidence) on `bench.py`'s load, one JSON line each, on the CUDA card.

    python -m tpu_mot_torch.tools.bench_variants [--samples 7]
    python -m tpu_mot_torch.tools.bench_variants --device cpu --small

The rows are `tools/bench_variants.py:45-63`'s, with the same names and
configs; each runs `tools/bench.py`'s protocol on its fixture (a warm-up
run from an empty bank gives MOTA, then `--samples` dependent runs; `fps`
is the frames of a run over the median run time).  A row's line has the
JAX tool's keys (variant, fps, mota_sanity) plus metric, spread_fps and
device (the card's name and power limit).  The last row,
"fhog31 + 3-scale (kcf_precision=default)", names a TPU precision knob
that the port ignores: on the card it computes what the row above it
computes, and its line says so; it is kept for parity of the names.
"""

from __future__ import annotations

import json
import statistics

from tpu_mot_torch.config import KCFConfig
from tpu_mot_torch.tools import bench

HEAVY_KCF = dict(feature_type="hog", cell_size=4, scale_step=1.05)
VARIANTS = {
    "default (gray, psr@5, appearance off)": {},
    "peak-ungated (r1 bench config)": dict(
        confidence_mode="peak", min_psr=0.0, appearance_weight=0.0),
    "fhog31 (cell 4)": dict(kcf=KCFConfig(feature_type="hog", cell_size=4)),
    "3-scale (step 1.05)": dict(kcf=KCFConfig(scale_step=1.05)),
    "fhog31 + 3-scale": dict(kcf=KCFConfig(**HEAVY_KCF)),
    "fhog31 + 3-scale (kcf_precision=default)": dict(
        kcf=KCFConfig(**HEAVY_KCF), kcf_precision="default"),
}
NOTES = {
    "fhog31 + 3-scale (kcf_precision=default)":
        "kcf_precision is a TPU knob the port ignores (fp32 throughout): "
        "this row computes what the row 'fhog31 + 3-scale' computes",
}


def row(name: str, fx: bench.Fixture, out, secs: list[float], dev) -> dict:
    n = len(fx.frames)
    line = {"variant": name,
            "fps": round(n / statistics.median(secs), 1),
            "mota_sanity": round(float(bench.scores(out, fx)["mota"]), 4),
            "metric": bench.metric_name(bench.METRIC, dev, fx.small),
            "spread_fps": bench.spread(n, secs),
            "device": bench.device_name(dev)}
    if name in NOTES:
        line["note"] = NOTES[name]
    return line


def run(fx: bench.Fixture, samples: int = 7, device=None):
    """Each variant in turn: yields (name, the warm-up run's StepOutput,
    seconds of each sample)."""
    for name in VARIANTS:
        out, secs = bench.run(fx, fx.config(**VARIANTS[name]), samples,
                              device)
        yield name, out, secs


def main(argv=None) -> tuple[list[dict], dict]:
    """Print one JSON line a variant; returns (the lines, {name: the
    warm-up run's StepOutput})."""
    args = bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = bench.device_of(args)
    fx = bench.fixture(args.small)
    lines, outs = [], {}
    for name, out, secs in run(fx, args.samples, dev):
        lines.append(row(name, fx, out, secs, dev))
        outs[name] = out
        print(json.dumps(lines[-1]), flush=True)
    return lines, outs


if __name__ == "__main__":
    main()
