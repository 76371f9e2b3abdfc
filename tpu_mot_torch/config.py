"""Configuration of the port: the fields, defaults, validation and resolved
properties of tpu_mot/config.py, copied so that the port needs nothing of
the JAX package.  A config built from the same keyword arguments in both
packages describes the same tracker (tests/test_torch_config.py holds the
two field for field).

Every knob lives in one frozen, hashable dataclass.  The impl knobs name
the TPU package's implementations; how the port reads each of them is in
tpu_mot_torch/tracker/step.py's docstring.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KCFConfig:
    """Hyper-parameters of the KCF correlation-filter core (arXiv:1404.7584
    §8 / Table 1, raw-pixel defaults)."""

    # Template (patch) size in pixels.
    template_size: int = 64
    # Context padding: the tracked window covers padding * target box.
    padding: float = 2.5
    # Ridge-regression regularizer lambda (eq. 17).
    lambda_: float = 1e-4
    # Gaussian kernel bandwidth sigma (eq. 31).
    kernel_sigma: float = 0.2
    # Desired-response bandwidth: sigma_y = sqrt(h*w) / padding * this.
    output_sigma_factor: float = 0.125
    # Model EMA learning rate ("interp factor").
    interp_factor: float = 0.075
    # "gray" (raw pixels, 1 channel) or "hog" (fHOG, 31 channels over
    # cell_size x cell_size cells).
    feature_type: str = "gray"
    cell_size: int = 1
    # Multi-scale search: scale step (1.0 disables; 1.05 = +-5% pyramid).
    scale_step: float = 1.0
    # Penalty applied to non-unit scale responses (scale hysteresis).
    scale_weight: float = 0.95

    def __post_init__(self):
        if self.template_size % self.cell_size != 0:
            raise ValueError(
                f"template_size ({self.template_size}) must be a multiple "
                f"of cell_size ({self.cell_size})")
        if self.template_size // self.cell_size < 2:
            raise ValueError(
                "feature_size (template_size // cell_size = "
                f"{self.template_size // self.cell_size}) must be >= 2 — a "
                "1-pixel feature map degenerates the Hann window and FFT")
        if self.feature_type not in ("gray", "hog"):
            raise ValueError(f"unknown feature_type {self.feature_type!r}")
        if self.padding <= 0:
            raise ValueError("padding must be positive")
        if self.scale_step < 1.0:
            raise ValueError("scale_step must be >= 1.0 (1.0 disables)")

    @property
    def feature_size(self) -> int:
        """Spatial extent of the feature map the FFT runs on."""
        return self.template_size // self.cell_size

    @property
    def num_channels(self) -> int:
        return 31 if self.feature_type == "hog" else 1

    @property
    def spectrum_width(self) -> int:
        """Width of the rfft2 half-spectrum."""
        return self.feature_size // 2 + 1


@dataclasses.dataclass(frozen=True)
class KalmanConfig:
    """Constant-velocity Kalman filter over box state [cx, cy, w, h, v*4]
    (SORT-lineage noise scales)."""

    pos_std_factor: float = 1.0 / 20.0   # measurement std ~ box size
    init_vel_cov: float = 1e4            # uninformative velocity prior
    process_pos_std: float = 1.0 / 20.0
    process_vel_std: float = 1.0 / 160.0


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Full MOT pipeline configuration."""

    kcf: KCFConfig = KCFConfig()
    kalman: KalmanConfig = KalmanConfig()

    # Static capacity of the track bank (slots).
    max_tracks: int = 128
    # Static per-frame detection capacity (padding target).
    max_detections: int = 64

    # Association.
    iou_gate: float = 0.3          # min IoU for a feasible match
    appearance_weight: float = 0.0  # cost = (1-w)*(1-IoU) + w*(1-appearance)
    cost_infeasible: float = 1e4   # cost assigned to gated pairs
    # Carry the auction's prices and matching across frames.
    auction_warm_start: bool = False
    # A track only matches detections of its birth class (class id in a
    # 6th detection column).
    class_aware: bool = False
    # Track box the association cost scores: "refined" (KCF-refined),
    # "predicted" (Kalman), "best" (better IoU of the two); "auto" resolves
    # per class_aware (assoc_box_resolved).
    assoc_box: str = "auto"

    # Lifecycle (SORT-style tentative/confirmed/lost state machine).
    n_init: int = 2                # hits to confirm a tentative track
    max_age: int = 30              # frames unmatched before a track dies
    max_age_tentative: int = 2     # unmatched frames allowed while tentative

    # KCF integration: run correlation detect to refine predicted boxes.
    use_kcf: bool = True
    # Minimum KCF confidence to trust the correlation update, per
    # confidence_mode: "peak" (raw max response) or "psr" (peak-to-sidelobe
    # ratio).  None = per-mode default (psr: 5.0, peak: 0.35).
    min_psr: float | None = None
    confidence_mode: str = "psr"
    # Detection confidence floor.
    det_score_min: float = 0.0

    # Frame geometry.
    frame_height: int = 480
    frame_width: int = 640

    # ROI extraction: "auto" | "pallas" (pyramid + the ROI kernels) |
    # "xla" (the gather path).
    roi_impl: str = "auto"
    # KCF chain: "auto" | "pallas" (the fused detect/train kernels) |
    # "xla" (the FFT chain).  "auto" resolves to the FFT chain.
    kcf_impl: str = "auto"
    # TPU matrix-unit precision of the JAX package's DFTs; validated here
    # as there, and ignored by the port (fp32 throughout).
    kcf_precision: str = "auto"
    # TPU tracks per grid program of the fused KCF kernels (ignored).
    kcf_block: int = 16
    # TPU lax.scan unroll factor (ignored).
    scan_unroll: int = 1
    # Auction assignment: "auto" | "pallas" (the auction kernel) | "xla".
    assign_impl: str = "auto"

    # Emit only confirmed tracks matched within this many frames.
    output_max_tsu: int = 10 ** 6

    # KCF retrain sample site: "refined" re-extracts patches at the
    # corrected boxes (a second ROI extraction and feature pass per frame);
    # "detect" reuses the detect-site spectra, phase-aligned to the
    # corrected centers (births initialise one frame late and KCF
    # refinement is gated off for that frame).
    train_site: str = "detect"

    def __post_init__(self):
        if self.train_site not in ("refined", "detect"):
            raise ValueError(f"unknown train_site {self.train_site!r}")
        if self.confidence_mode not in ("peak", "psr"):
            raise ValueError(
                f"unknown confidence_mode {self.confidence_mode!r}")
        if self.roi_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown roi_impl {self.roi_impl!r}")
        if self.kcf_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown kcf_impl {self.kcf_impl!r}")
        if self.assoc_box not in ("auto", "refined", "predicted", "best"):
            raise ValueError(f"unknown assoc_box {self.assoc_box!r}")
        if self.assign_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown assign_impl {self.assign_impl!r}")
        if self.kcf_precision not in ("auto", "highest", "high",
                                      "fwd_high", "default"):
            raise ValueError(
                f"unknown kcf_precision {self.kcf_precision!r}")
        if (self.kcf_impl == "pallas"
                and self.kcf_precision in ("high", "fwd_high")):
            raise ValueError(
                f"kcf_precision={self.kcf_precision!r} applies to the XLA "
                "chain only (Mosaic supports only 'highest' and 'default' "
                "dots)")
        if self.kcf_block < 1:
            raise ValueError("kcf_block must be >= 1")
        if self.max_tracks < 1 or self.max_detections < 1:
            raise ValueError("max_tracks and max_detections must be >= 1")
        if self.frame_height < 1 or self.frame_width < 1:
            raise ValueError("frame dimensions must be positive")

    @property
    def kcf_precision_resolved(self) -> str:
        """kcf_precision with "auto" resolved per kcf_impl: "highest" for
        the fused kernels, "fwd_high" for the FFT chain."""
        if self.kcf_precision != "auto":
            return self.kcf_precision
        return "highest" if self.kcf_impl == "pallas" else "fwd_high"

    @property
    def assoc_box_resolved(self) -> str:
        """assoc_box with "auto" resolved per class_aware."""
        if self.assoc_box != "auto":
            return self.assoc_box
        return "best" if self.class_aware else "refined"

    @property
    def confidence_threshold(self) -> float:
        """min_psr resolved per confidence_mode."""
        if self.min_psr is not None:
            return self.min_psr
        return 5.0 if self.confidence_mode == "psr" else 0.35

    def replace(self, **kw) -> "TrackerConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = TrackerConfig()
