"""ROI path of the port (tpu_mot_torch.kernels.roi) against the JAX ROI
path: the pyramid against tpu_mot.kernels.roi.build_pyramid, and the plain
resample against the Pallas kernel run in interpret mode on the CPU.

Tolerances: u8 pyramid levels exact (integer arithmetic on both sides);
f32 levels atol 1e-6 (a 2x2 mean summed in another order); patches atol
1e-5 (the same hat-weight matmuls in float32, summed in another order).
The CUDA kernel itself is tested on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mot.kernels import roi as j_roi
from tpu_mot_torch.kernels import roi as t_roi

# The tensors here are small: torch's intra-op thread pool would only
# oversubscribe the cores that the JAX side and the other test workers use.
torch.set_num_threads(1)

# A frame large enough that level 3 (145 x 263) exceeds the 144 x 256
# block, so windows over 1024 px really are truncated.
H, W = 1160, 2100

# Corners, degenerate and negative sizes, off-frame, level boundaries
# (window = 2.5 * size; 128 px is the level-0/1 edge), windows over
# 1024 px that truncate in rows and in columns.
BOXES = np.array([
    [0.0, 0.0, 20.0, 20.0],
    [W - 1.0, H - 1.0, 30.0, 18.0],
    [0.0, H - 1.0, 40.0, 40.0],
    [500.0, 400.0, 0.0, 0.0],
    [700.0, 300.0, -4.0, 12.0],
    [5000.0, -300.0, 20.0, 20.0],
    [300.0, 200.0, 51.2, 10.0],
    [310.0, 210.0, 51.21, 10.0],
    [900.0, 500.0, 102.4, 60.0],
    [950.0, 550.0, 102.5, 60.0],
    [1200.0, 700.0, 30.0, 204.8],
    [1000.0, 580.0, 600.0, 600.0],
    [1050.0, 580.0, 1000.0, 100.0],
    [123.4, 567.8, 37.5, 25.25],
    [1777.7, 111.1, 64.0, 48.0],
    [1500.0, 900.0, 420.0, 300.0],
], np.float32)


def _frame_u8(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (H, W),
                                                dtype=np.uint8)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("case", ["u8", "u8_as_f32", "unit_f32",
                                  "byte_f32"])
def test_pyramid_matches_jax(case):
    """The port's pyramid dtype follows the frame's (u8 -> u8, float ->
    f32); JAX's is asked for the same dtype.  "u8_as_f32" holds the port's
    float path on u8 / 255 against JAX's u8 frame -> f32 pyramid."""
    rng = np.random.default_rng(1)
    h, w = 121, 203                                   # odd extents
    u8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
    unit = u8.astype(np.float32) / 255.0
    frame_t, frame_j, dtype_j = {
        "u8": (u8, u8, None),
        "u8_as_f32": (unit, u8, jnp.float32),
        "unit_f32": (unit, unit, jnp.float32),
        "byte_f32": (u8.astype(np.float32), u8.astype(np.float32),
                     jnp.float32),
    }[case]
    got = t_roi.build_pyramid(_t(frame_t))
    want = j_roi.build_pyramid(jnp.asarray(frame_j), dtype=dtype_j)
    exact = got[0].dtype == torch.uint8
    assert exact == (want[0].dtype == jnp.uint8)
    for lv, (g, wj) in enumerate(zip(got, want)):
        assert tuple(g.shape) == t_roi.level_extents(h, w)[lv]
        g = g.numpy()
        wj = np.asarray(wj)
        assert wj.shape == t_roi._level_shapes(h, w)[lv]
        assert not np.any(wj[g.shape[0]:]) and not np.any(wj[:, g.shape[1]:])
        if exact:
            np.testing.assert_array_equal(g, wj[:g.shape[0], :g.shape[1]])
        else:
            np.testing.assert_allclose(g, wj[:g.shape[0], :g.shape[1]],
                                       rtol=0, atol=1e-6)


def test_level_shapes_match_jax():
    for h, w in [(1080, 1920), (240, 320), (121, 203), (H, W)]:
        assert t_roi._level_shapes(h, w) == j_roi._level_shapes(h, w)


@pytest.mark.parametrize("pyramid", ["u8", "f32"])
def test_plain_resample_matches_pallas_interpret(pyramid):
    """extract_patches_ref against extract_patches_pallas(interpret=True)
    on one pyramid, every edge case of BOXES included."""
    frame = _frame_u8(2)
    if pyramid == "u8":
        want = j_roi.extract_patches_pallas(
            jnp.asarray(frame), jnp.asarray(BOXES), 2.5, 64, interpret=True,
            levels=j_roi.build_pyramid(jnp.asarray(frame)), frame_hw=(H, W))
        levels = t_roi.build_pyramid(_t(frame))
    else:
        gray = frame.astype(np.float32) / 255.0
        want = j_roi.extract_patches_pallas(
            jnp.asarray(gray), jnp.asarray(BOXES), 2.5, 64, interpret=True,
            dtype=jnp.float32)
        levels = t_roi.build_pyramid(_t(gray))
    got = t_roi.extract_patches_ref(None, _t(BOXES), 2.5, 64, levels=levels,
                                    frame_hw=(H, W)).numpy()
    want = np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    lvl = t_roi.sample_coords(_t(BOXES), 2.5, 64, (H, W))[0].numpy()
    assert set(lvl.tolist()) == {0, 1, 2, 3}       # every level exercised


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    frame = _t(_frame_u8(3)[:480, :640])
    boxes = _t(BOXES[:6] * 0.3)
    before = t_roi.launches
    got = t_roi.extract_patches(frame, boxes, 2.5, 64)
    assert torch.equal(got, t_roi.extract_patches_ref(frame, boxes, 2.5, 64))
    assert t_roi.launches == before


SCALES = (1 / 1.05, 1.0, 1.05)


def _smooth_frame(seed, h, w):
    rng = np.random.default_rng(seed)
    return np.kron(rng.random((h // 8, w // 8)),
                   np.ones((8, 8))).astype(np.float32)


@pytest.mark.parametrize("case", ["level0", "straddling", "u8"])
def test_scales_plain_matches_pallas_interpret(case):
    """K3's plain version against extract_patches_scales_pallas in
    interpret mode, on the inputs of tests/test_roi_kernel.py: small boxes
    (every scale at level 0), a box whose scales straddle the level 0/1
    boundary (K3 takes the largest scale's level for all three), and a u8
    pyramid.  atol 1e-5."""
    if case == "level0":
        frame = np.random.default_rng(1).random((240, 320)).astype(
            np.float32)
        boxes = np.array([[70.0, 50.0, 20.0, 26.0], [150.0, 120.0, 40.0, 30.0],
                          [250.0, 60.0, 16.0, 16.0]], np.float32)
    elif case == "straddling":
        frame = _smooth_frame(2, 480, 640)
        boxes = np.array([[300.0, 240.0, 50.0, 50.0]], np.float32)
    else:
        frame = (np.random.default_rng(3).random((240, 320)) * 255).astype(
            np.uint8)
        boxes = np.array([[70.0, 50.0, 20.0, 26.0],
                          [150.0, 120.0, 40.0, 30.0]], np.float32)
    hw = frame.shape
    if case == "u8":
        want = j_roi.extract_patches_scales_pallas(
            jnp.asarray(frame), jnp.asarray(boxes), 2.5, 64, SCALES,
            interpret=True, levels=j_roi.build_pyramid(jnp.asarray(frame)),
            frame_hw=hw)
    else:
        want = j_roi.extract_patches_scales_pallas(
            jnp.asarray(frame), jnp.asarray(boxes), 2.5, 64, SCALES,
            interpret=True, dtype=jnp.float32)
    levels = t_roi.build_pyramid(_t(frame))
    assert levels[0].dtype == (torch.uint8 if case == "u8"
                               else torch.float32)
    got = t_roi.extract_patches_scales_ref(None, _t(boxes), 2.5, 64, SCALES,
                                           levels=levels, frame_hw=hw)
    assert got.shape == (3, boxes.shape[0], 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    lvl = t_roi.sample_coords_scales(_t(boxes), 2.5, 64, SCALES, hw)[0]
    assert lvl.tolist() == ([1] if case == "straddling"
                            else [0] * boxes.shape[0])


def test_scales_on_big_frame_every_level():
    """K3's plain version on the 1160 x 2100 frame with every edge case of
    BOXES (levels 0-3, truncated windows) against interpret mode."""
    frame = _frame_u8(4)
    want = j_roi.extract_patches_scales_pallas(
        jnp.asarray(frame), jnp.asarray(BOXES), 2.5, 32, SCALES,
        interpret=True, levels=j_roi.build_pyramid(jnp.asarray(frame)),
        frame_hw=(H, W))
    got = t_roi.extract_patches_scales(_t(frame), _t(BOXES), 2.5, 32,
                                       SCALES).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_cpu_scales_wrapper_is_the_plain_version_and_launches_nothing():
    frame = _t(_frame_u8(5)[:480, :640])
    boxes = _t(BOXES[:6] * 0.3)
    before = t_roi.launches_scales
    got = t_roi.extract_patches_scales(frame, boxes, 2.5, 64, SCALES)
    assert torch.equal(got, t_roi.extract_patches_scales_ref(
        frame, boxes, 2.5, 64, SCALES))
    assert t_roi.launches_scales == before
    # The scale axis leads: scale k equals K1 at the scaled box wherever K3
    # keeps K1's level (small boxes: level 0 at every scale).
    small = _t(np.array([[100.0, 90.0, 20.0, 24.0]], np.float32))
    three = t_roi.extract_patches_scales(frame, small, 2.5, 64, SCALES)
    for k, sv in enumerate(SCALES):
        one = t_roi.extract_patches(frame, small, 2.5, 64,
                                    scales=torch.full((1,), sv))
        np.testing.assert_allclose(three[k].numpy(), one.numpy(), rtol=0,
                                   atol=1e-5)


# ---- torch mirror of the CUDA kernels' 4-tap form -------------------------
# The kernels never form the hat-weight matmuls: per output they take two
# taps per axis under the tap rules of csrc/roi.cu (`tap_of`).  The mirror
# repeats those rules in torch; here it is held to the plain version (the
# matmuls) on the cases where the rules matter.

def _mirror_boxes(case):
    if case == "edges":
        return BOXES
    if case == "straddle":        # 125 px at unit scale, 131 px at 1.05
        return np.array([[300.0, 240.0, 50.0, 50.0]], np.float32)
    if case == "over_1024":       # level 3, truncated by the 144 x 256 block
        return np.array([[1000.0, 580.0, 600.0, 600.0],
                         [1050.0, 580.0, 1000.0, 100.0],
                         [2000.0, 1100.0, 500.0, 450.0]], np.float32)
    rng = np.random.default_rng(37)                   # "t37": a ragged T
    return np.stack([rng.uniform(0, W, 37), rng.uniform(0, H, 37),
                     rng.uniform(8, 300, 37), rng.uniform(8, 300, 37)],
                    axis=1).astype(np.float32)


@pytest.mark.parametrize("case", ["edges", "straddle", "over_1024", "t37"])
@pytest.mark.parametrize("pyramid", ["u8", "f32"])
def test_four_tap_mirror_matches_plain_version(pyramid, case):
    """max |mirror - plain| <= 1e-5: both sum the same two nonzero products
    per axis in float32, the matmuls among zeros and in another order."""
    frame = _frame_u8(6)
    levels = t_roi.build_pyramid(
        _t(frame if pyramid == "u8" else frame.astype(np.float32) / 255.0))
    boxes = _t(_mirror_boxes(case))
    coords = t_roi.sample_coords_scales(boxes, 2.5, 64, SCALES, (H, W))
    want = t_roi._resample_scales_ref(levels, (H, W), *coords)
    got = t_roi.four_tap_mirror(levels, (H, W), *coords)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (3, boxes.shape[0], 64, 64)
    assert (got - want).abs().max().item() <= 1e-5
    assert want.abs().max().item() > 0.1              # not trivially zero
    lvl = set(coords[0].tolist())
    assert lvl == {"edges": {0, 1, 2, 3}, "straddle": {1},
                   "over_1024": {3}, "t37": lvl}[case]


def test_four_tap_mirror_one_scale_matches_k1_plain_version():
    """K = 1 with K1's coordinates is K1's resample."""
    frame = _frame_u8(7)
    levels = t_roi.build_pyramid(_t(frame))
    lvl, r0, c0, ys, xs = t_roi.sample_coords(_t(BOXES), 2.5, 48, (H, W))
    want = t_roi._resample_ref(levels, (H, W), lvl, r0, c0, ys, xs)
    got = t_roi.four_tap_mirror(levels, (H, W), lvl, r0, c0, ys[None],
                                xs[None])[0]
    assert (got - want).abs().max().item() <= 1e-5


# K1 on the card is the tile function at K = 1 and equals the mirror bit for
# bit there; here the mirror at K1's shapes is held to K1's plain version.
# "bank3" is the single-object bank's 3-scale call: the boxes three times,
# scale-major, with a per-track `scales` vector.
@pytest.mark.parametrize("case", ["edges", "t37", "bank3"])
@pytest.mark.parametrize("s", [64, 30])
@pytest.mark.parametrize("pyramid", ["u8", "f32"])
def test_four_tap_mirror_k1_shapes_match_extract_patches_ref(pyramid, s,
                                                             case):
    """max |mirror - plain| <= 1e-6 at K = 1 (measured 2.4e-7: the same two
    nonzero products per axis)."""
    frame = _frame_u8(8)
    levels = t_roi.build_pyramid(
        _t(frame if pyramid == "u8" else frame.astype(np.float32) / 255.0))
    boxes = _t(_mirror_boxes("t37" if case == "bank3" else case))
    scales = None
    if case == "bank3":
        scales = torch.tensor(SCALES, dtype=torch.float32).repeat_interleave(
            boxes.shape[0])
        boxes = boxes.repeat(3, 1)
    want = t_roi.extract_patches_ref(None, boxes, 2.5, s, levels=levels,
                                     frame_hw=(H, W), scales=scales)
    lvl, r0, c0, ys, xs = t_roi.sample_coords(boxes, 2.5, s, (H, W), scales)
    got = t_roi.four_tap_mirror(levels, (H, W), lvl, r0, c0, ys[None],
                                xs[None])[0]
    assert got.shape == want.shape == (boxes.shape[0], s, s)
    assert (got - want).abs().max().item() <= 1e-6
    assert want.abs().max().item() > 0.1
    if case == "bank3":           # the three scales differ
        t = boxes.shape[0] // 3
        assert not torch.equal(got[:t], got[t:2 * t])


# ---- serving: S frames stacked, stream-major rows --------------------------

def test_build_pyramid_mixed_unit_and_byte_frames():
    """A float batch of one [0, 1] frame and one [0, 255] frame: each
    frame picks its own domain (the JAX pyramid under vmap), so each
    stacked level equals the frame's own pyramid and JAX's; u8 stacks
    likewise."""
    rng = np.random.default_rng(3)
    h, w = 121, 203
    u8 = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    mixed = np.stack([u8[0].astype(np.float32) / 255.0,
                      u8[1].astype(np.float32)])
    for frames in (mixed, u8):
        got = t_roi.build_pyramid(_t(frames))
        assert t_roi.n_frames(got) == 2
        for s in range(2):
            one = t_roi.build_pyramid(_t(frames[s]))
            want = j_roi.build_pyramid(
                jnp.asarray(frames[s]),
                dtype=None if frames.dtype == np.uint8 else jnp.float32)
            for lv in range(t_roi.N_LEVELS):
                assert torch.equal(got[lv][s], one[lv])
                g = got[lv][s].numpy()
                wj = np.asarray(want[lv])[:g.shape[0], :g.shape[1]]
                np.testing.assert_allclose(g, wj, rtol=0, atol=1e-6)
    # both float frames end in [0, 1]: the byte frame was scaled
    top = t_roi.build_pyramid(_t(mixed))[0].amax(dim=(1, 2))
    assert (top <= 1.0).all() and (top > 0.9).all()


@pytest.mark.parametrize("pyramid", ["u8", "f32"])
def test_stacked_plain_versions_equal_single_frames(pyramid):
    """Three frames [3, H, W] and 3 x 16 stream-major boxes: K1's and K3's
    plain versions, the 4-tap mirror and the CPU wrappers equal the calls
    on each frame alone, bit for bit."""
    frames = np.stack([_frame_u8(s) for s in (11, 12, 13)])
    if pyramid == "f32":
        frames = frames.astype(np.float32) / 255.0
    levels = t_roi.build_pyramid(_t(frames))
    boxes = _t(np.concatenate([BOXES, BOXES[::-1], BOXES[::2].repeat(2, 0)]))
    hw = (H, W)
    c1 = t_roi.sample_coords(boxes, 2.5, 48, hw)
    c3 = t_roi.sample_coords_scales(boxes, 2.5, 48, SCALES, hw)
    got = {"k1": t_roi._resample_ref(levels, hw, *c1),
           "k3": t_roi._resample_scales_ref(levels, hw, *c3),
           "mirror": t_roi.four_tap_mirror(levels, hw, *c3),
           "wrapper": t_roi.extract_patches(None, boxes, 2.5, 48,
                                            levels=levels, frame_hw=hw),
           "no pyramid": t_roi.extract_patches_scales_ref(
               _t(frames), boxes, 2.5, 48, SCALES)}
    assert got["no pyramid"].shape == (3, 48, 48, 48)
    for s in range(3):
        rows = slice(16 * s, 16 * (s + 1))
        one = [lv[s] for lv in levels]
        o1 = t_roi.sample_coords(boxes[rows], 2.5, 48, hw)
        o3 = t_roi.sample_coords_scales(boxes[rows], 2.5, 48, SCALES, hw)
        assert torch.equal(got["k1"][rows], t_roi._resample_ref(one, hw, *o1))
        assert torch.equal(got["k3"][:, rows],
                           t_roi._resample_scales_ref(one, hw, *o3))
        assert torch.equal(got["mirror"][:, rows],
                           t_roi.four_tap_mirror(one, hw, *o3))
        assert torch.equal(got["wrapper"][rows], t_roi.extract_patches(
            None, boxes[rows], 2.5, 48, levels=one, frame_hw=hw))
        assert torch.equal(got["no pyramid"][:, rows],
                           t_roi.extract_patches_scales_ref(
                               _t(frames[s]), boxes[rows], 2.5, 48, SCALES))
    assert (got["mirror"] - got["k3"]).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="not a multiple"):
        t_roi._resample_ref(levels, hw, *t_roi.sample_coords(
            boxes[:47], 2.5, 48, hw))


def test_gather_path_with_frame_index():
    """The gather path (roi_impl="xla") reads each box's own frame."""
    from tpu_mot_torch.ops import patch as t_patch

    rng = np.random.default_rng(5)
    frames = rng.random((3, 96, 128)).astype(np.float32)
    boxes = np.stack([rng.uniform(0, 128, 12), rng.uniform(0, 96, 12),
                      rng.uniform(4, 40, 12), rng.uniform(4, 40, 12)],
                     axis=1).astype(np.float32)
    frame = torch.arange(3).repeat_interleave(4)
    got = t_patch.extract_patches(_t(frames), _t(boxes), 2.5, 32,
                                  frame=frame)
    for s in range(3):
        rows = slice(4 * s, 4 * (s + 1))
        assert torch.equal(got[rows], t_patch.extract_patches(
            _t(frames[s]), _t(boxes[rows]), 2.5, 32))
    gray = t_patch.to_gray(_t(rng.random((2, 8, 10, 3)).astype(np.float32)),
                           batched=True)
    assert gray.shape == (2, 8, 10)
