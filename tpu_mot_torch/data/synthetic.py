"""Synthetic moving-object sequences with known ground truth (a copy of
tpu_mot/data/synthetic.py, NumPy only, so the port and its smoke test need
nothing of the JAX package).

Textured rectangles on a textured background, constant-velocity motion
with border bounce, per-frame ground-truth boxes and visibility, and a
detector simulated from the ground truth.  The same seed gives the same
frames, boxes and detections bit for bit as the JAX package's module.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticObject:
    cx: float
    cy: float
    w: float
    h: float
    vx: float
    vy: float
    appear: int = 0          # first frame the object exists
    vanish: int = 10 ** 9    # frame the object disappears
    # Optional occlusion window [start, end): the object is not drawn and
    # not visible, but keeps moving — the fixture for testing confidence
    # gating / re-acquisition after occlusion (SURVEY.md §5 fault
    # injection).
    occlude: tuple | None = None
    # Detector class of the object (class-aware MOT fixtures): selects a
    # visually distinct texture family in render_sequence so a trained
    # detector can actually LEARN the class — 0 speckle, 1 horizontal
    # stripes, 2 checkerboard (mod 3 beyond that).
    cls: int = 0

    def visible_at(self, f: int) -> bool:
        if not (self.appear <= f < self.vanish):
            return False
        if self.occlude is not None and \
                self.occlude[0] <= f < self.occlude[1]:
            return False
        return True


def make_objects(n: int, height: int, width: int, rng: np.random.Generator,
                 min_size: int = 16, max_size: int = 40,
                 max_speed: float = 3.0, lifespan: tuple | None = None,
                 n_classes: int = 1) -> list[SyntheticObject]:
    objs = []
    for _ in range(n):
        w = float(rng.integers(min_size, max_size))
        h = float(rng.integers(min_size, max_size))
        objs.append(SyntheticObject(
            cx=float(rng.uniform(w, width - w)),
            cy=float(rng.uniform(h, height - h)),
            w=w, h=h,
            vx=float(rng.uniform(-max_speed, max_speed)),
            vy=float(rng.uniform(-max_speed, max_speed)),
            appear=0 if lifespan is None else int(rng.integers(*lifespan)),
            # The class draw happens only when requested, keeping the rng
            # stream (and every existing fixture/golden) bit-identical
            # for the default single-class path.
            cls=int(rng.integers(0, n_classes)) if n_classes > 1 else 0,
        ))
    return objs


def render_sequence(objects: list[SyntheticObject], n_frames: int,
                    height: int = 240, width: int = 320, seed: int = 0,
                    noise: float = 0.02):
    """Render frames and ground truth.

    Returns (frames [N, H, W] float32 in [0,1],
             boxes  [N, K, 4] (cx, cy, w, h),
             visible [N, K] bool).
    """
    rng = np.random.default_rng(seed)
    # Smooth background texture: low-frequency noise.
    bg_small = rng.random((height // 8 + 1, width // 8 + 1))
    bg = np.kron(bg_small, np.ones((8, 8)))[:height, :width] * 0.4 + 0.2
    textures = []
    for o in objects:
        th, tw = int(round(o.h)), int(round(o.w))
        # The rng draw happens for every class (stream stays aligned for
        # mixed-class sequences); class families reshape the SAME draw so
        # single-class sequences remain bit-identical to pre-class code.
        tex = rng.random((th, tw)) * 0.6 + 0.4
        fam = int(getattr(o, "cls", 0)) % 3
        if fam == 1:                       # horizontal stripes
            rows = (np.arange(th)[:, None] // 3) % 2
            tex = 0.25 + 0.65 * rows + (tex - 0.7) * 0.15
        elif fam == 2:                     # checkerboard
            ys, xs_ = np.meshgrid(np.arange(th), np.arange(tw),
                                  indexing="ij")
            checks = ((ys // 4) + (xs_ // 4)) % 2
            tex = 0.25 + 0.65 * checks + (tex - 0.7) * 0.15
        # Strong border so the box edge is a trackable feature.
        tex[0, :] = tex[-1, :] = tex[:, 0] = tex[:, -1] = 1.0
        textures.append(np.clip(tex, 0.0, 1.0))

    frames = np.empty((n_frames, height, width), np.float32)
    boxes = np.zeros((n_frames, len(objects), 4), np.float32)
    visible = np.zeros((n_frames, len(objects)), bool)
    state = [(o.cx, o.cy, o.vx, o.vy) for o in objects]

    for f in range(n_frames):
        img = bg.copy()
        for k, o in enumerate(objects):
            cx, cy, vx, vy = state[k]
            if o.visible_at(f):
                tex = textures[k]
                th, tw = tex.shape
                y0 = int(round(cy - th / 2))
                x0 = int(round(cx - tw / 2))
                ys = slice(max(y0, 0), min(y0 + th, height))
                xs = slice(max(x0, 0), min(x0 + tw, width))
                tys = slice(ys.start - y0, ys.stop - y0)
                txs = slice(xs.start - x0, xs.stop - x0)
                if ys.stop > ys.start and xs.stop > xs.start:
                    img[ys, xs] = tex[tys, txs]
                boxes[f, k] = (cx, cy, o.w, o.h)
                visible[f, k] = True
            # Advance with border bounce.
            cx += vx
            cy += vy
            if cx - o.w / 2 < 0 or cx + o.w / 2 > width:
                vx = -vx
                cx += 2 * vx
            if cy - o.h / 2 < 0 or cy + o.h / 2 > height:
                vy = -vy
                cy += 2 * vy
            state[k] = (cx, cy, vx, vy)
        if noise > 0:
            img = img + rng.normal(0, noise, img.shape)
        frames[f] = np.clip(img, 0.0, 1.0)
    return frames, boxes, visible


def render_trajectories(centers: np.ndarray, sizes: np.ndarray,
                        height: int = 240, width: int = 320, seed: int = 0,
                        noise: float = 0.02,
                        tex_levels: list | None = None,
                        visible: np.ndarray | None = None):
    """Render a sequence from EXPLICIT per-frame trajectories.

    Unlike render_sequence (constant velocity + border bounce), this takes
    scripted motion — the fixture hook for adversarial association
    scenarios (crossing / bouncing targets, VERDICT r2 next #5) where the
    interesting failure needs trajectories constant-velocity physics
    cannot produce.

    centers : [N, K, 2] per-frame (cx, cy) of K objects.
    sizes   : [K, 2] (w, h) per object.
    tex_levels : optional K base intensities in [0, 1] — distinct values
        give objects distinct textures the appearance term can tell
        apart; None = random textures as render_sequence.
    visible : optional [N, K] bool; None = all visible.

    Returns (frames [N, H, W] f32 in [0,1], boxes [N, K, 4], visible).
    """
    rng = np.random.default_rng(seed)
    n_frames, k_obj = centers.shape[:2]
    if visible is None:
        visible = np.ones((n_frames, k_obj), bool)
    bg_small = rng.random((height // 8 + 1, width // 8 + 1))
    bg = np.kron(bg_small, np.ones((8, 8)))[:height, :width] * 0.4 + 0.2
    textures = []
    for k in range(k_obj):
        tw, th = int(round(sizes[k, 0])), int(round(sizes[k, 1]))
        if tex_levels is not None:
            base = float(tex_levels[k])
            tex = np.clip(rng.random((th, tw)) * 0.25 + base, 0.0, 1.0)
        else:
            tex = rng.random((th, tw)) * 0.6 + 0.4
        tex[0, :] = tex[-1, :] = tex[:, 0] = tex[:, -1] = 1.0
        textures.append(tex)

    frames = np.empty((n_frames, height, width), np.float32)
    boxes = np.zeros((n_frames, k_obj, 4), np.float32)
    for f in range(n_frames):
        img = bg.copy()
        for k in range(k_obj):
            cx, cy = centers[f, k]
            boxes[f, k] = (cx, cy, sizes[k, 0], sizes[k, 1])
            if not visible[f, k]:
                continue
            tex = textures[k]
            th, tw = tex.shape
            y0 = int(round(cy - th / 2))
            x0 = int(round(cx - tw / 2))
            ys = slice(max(y0, 0), min(y0 + th, height))
            xs = slice(max(x0, 0), min(x0 + tw, width))
            tys = slice(ys.start - y0, ys.stop - y0)
            txs = slice(xs.start - x0, xs.stop - x0)
            if ys.stop > ys.start and xs.stop > xs.start:
                img[ys, xs] = tex[tys, txs]
        if noise > 0:
            img = img + rng.normal(0, noise, img.shape)
        frames[f] = np.clip(img, 0.0, 1.0)
    return frames, boxes, visible


def detections_from_gt(boxes: np.ndarray, visible: np.ndarray, seed: int = 0,
                       jitter: float = 1.0, drop_prob: float = 0.0,
                       fp_per_frame: float = 0.0, frame_hw=(240, 320),
                       classes=None):
    """Simulate a detector from ground truth: jittered boxes, dropped
    detections, false positives.  Returns per-frame list of [D_f, 5]
    arrays (cx, cy, w, h, score) — the fault-injection hook of
    SURVEY.md §5 ("failure detection").

    classes: optional [K] per-object class ids — detections then carry a
    6th class column ([D_f, 6], the cfg.class_aware form; false positives
    draw a uniform random class)."""
    rng = np.random.default_rng(seed)
    n_frames, n_obj = visible.shape
    ncol = 5 if classes is None else 6
    n_cls = (int(np.max(classes)) + 1) if classes is not None else 1
    out = []
    for f in range(n_frames):
        dets = []
        for k in range(n_obj):
            if not visible[f, k] or rng.random() < drop_prob:
                continue
            cx, cy, w, h = boxes[f, k]
            row = [cx + rng.normal(0, jitter),
                   cy + rng.normal(0, jitter),
                   w * (1 + rng.normal(0, 0.02)),
                   h * (1 + rng.normal(0, 0.02)),
                   float(rng.uniform(0.5, 1.0))]
            if classes is not None:
                row.append(float(classes[k]))
            dets.append(row)
        n_fp = rng.poisson(fp_per_frame)
        for _ in range(n_fp):
            row = [rng.uniform(20, frame_hw[1] - 20),
                   rng.uniform(20, frame_hw[0] - 20),
                   rng.uniform(10, 40), rng.uniform(10, 40),
                   float(rng.uniform(0.3, 0.6))]
            if classes is not None:
                row.append(float(rng.integers(0, n_cls)))
            dets.append(row)
        out.append(np.asarray(dets, np.float32).reshape(-1, ncol))
    return out
