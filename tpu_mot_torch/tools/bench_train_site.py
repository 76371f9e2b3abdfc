"""The port's twin of the repo's `tools/bench_train_site.py`: KCF training
at the corrected boxes ("refined", a second ROI extraction a frame) against
the Fourier-aligned reuse of the detect-site spectra ("detect"), on the
bench fixture in the default and the heavy configuration, on the CUDA card.

    python -m tpu_mot_torch.tools.bench_train_site [--samples 7]
    python -m tpu_mot_torch.tools.bench_train_site --device cpu --small

The rows are `tools/bench_train_site.py:49-60`'s: {default-gray,
fhog-3scale = `KCFConfig(feature_type="hog", cell_size=4,
scale_step=1.05)`} x {refined, detect} on `bench.py`'s load (1080p, 128
objects, 64 frames, 160 detection slots, 128 tracks).  default-gray/detect
is the default configuration and fhog-3scale/detect the heavy one (H);
under "refined" K1 extracts again at the corrected boxes, so it runs twice
a frame in default-gray (the detect-site window, then the training one)
and once in fhog-3scale beside K3's 3-scale search.  Like the JAX tool,
the twin reads no `TPU_MOT_KCF_IMPL`: `kcf_impl` stays "auto" (the FFT
chain), so the fused KCF kernels (K4, K5) stay off its path.

Each row runs `tools/bench.py`'s protocol: a warm-up run from an empty
bank, scored by `utils/metrics.clear_mot` against the ground truth (so a
fast but broken mode cannot win), then `--samples` dependent runs ended by
a synchronise and one small fetch; `fps` is the frames over the median
run.  One JSON line a row with the JAX tool's keys (config, train_site,
fps, mota_sanity, idf1, idsw) plus metric, spread_fps, n_samples and
device (the card's name and power limit).  `--small` is `tools/bench.py`'s
and is refused on the card.
"""

from __future__ import annotations

from tpu_mot_torch.config import KCFConfig
from tpu_mot_torch.tools import bench
from tpu_mot_torch.tools.bench_variants import HEAVY_KCF
from tpu_mot_torch.utils import metrics

VARIANTS = {"default-gray": {}, "fhog-3scale": HEAVY_KCF}
SITES = ("refined", "detect")


def config(fx: bench.Fixture, name: str, site: str):
    return fx.config(train_site=site, kcf=KCFConfig(**VARIANTS[name]))


def rows(fx: bench.Fixture) -> list[bench.Row]:
    return [bench.Row((name, site), config(fx, name, site))
            for name in VARIANTS for site in SITES]


def line(fx: bench.Fixture, row: bench.Row, out, secs: list[float]
         ) -> dict:
    m = metrics.clear_mot(*bench.gt_and_hyp(out, fx))
    return {"config": row.key[0], "train_site": row.key[1],
            "fps": bench.rates(len(fx.frames), secs)["fps"],
            "mota_sanity": round(float(m["mota"]), 4),
            "idf1": round(float(m["idf1"]), 4), "idsw": int(m["idsw"])}


def main(argv=None) -> tuple[list[dict], dict]:
    """Print one JSON line a row; returns (the lines, {(config, site): the
    warm-up run's StepOutput})."""
    return bench.table_main(argv, __doc__, rows, line)


if __name__ == "__main__":
    main()
