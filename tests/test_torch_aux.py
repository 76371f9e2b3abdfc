"""The port's aux modules (tpu_mot_torch.utils.supervisor, .profiling)
against their JAX counterparts' behaviour: the ports of
tests/test_aux.py:24-97 on device="cpu", output_healthy agreeing with
JAX's on the same outputs, and the torch.profiler trace summary."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import both_configs
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import step as j_step
from tpu_mot.utils import supervisor as j_sup
from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.tracker.api import pad_detections
from tpu_mot_torch.utils import profiling
from tpu_mot_torch.utils.profiling import DeviceTimer, FpsMeter
from tpu_mot_torch.utils.supervisor import StreamSupervisor, output_healthy

torch.set_num_threads(1)


def _scene(n_frames=12):
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(4, 120, 160, rng)
    frames, boxes, vis = synthetic.render_sequence(objs, n_frames, 120,
                                                   160, seed=0)
    dets = synthetic.detections_from_gt(boxes, vis, seed=0,
                                        frame_hw=(120, 160))
    return frames, dets


def _cfg(**kw):
    return TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                         frame_width=160, **kw)


def test_supervisor_normal_flow():
    frames, dets = _scene()
    sup = StreamSupervisor(_cfg(n_init=1), snapshot_every=4, device="cpu")
    for f in range(len(frames)):
        d, v = pad_detections(dets[f], 8)
        out = sup.step(frames[f], d, v)
    assert sup.failures == 0
    assert int(out.n_alive) == 4


def test_supervisor_recovers_from_poisoned_state():
    frames, dets = _scene()
    sup = StreamSupervisor(_cfg(n_init=1), snapshot_every=2, device="cpu")
    for f in range(6):
        d, v = pad_detections(dets[f], 8)
        sup.step(frames[f], d, v)
    snap = sup._snapshot.kf_mean.clone()
    # Poison the live bank (simulated corruption / device fault).
    kf = sup.bank.kf_mean.clone()
    kf[:, 0] = float("nan")
    sup.bank = sup.bank._replace(kf_mean=kf)
    d, v = pad_detections(dets[6], 8)
    out = sup.step(frames[6], d, v)
    assert sup.failures == 1 and sup.last_recovery_frame == 6
    assert torch.isfinite(out.boxes).all()
    # the snapshot is a copy the poison did not reach
    assert torch.isfinite(snap).all()
    # Keeps tracking afterwards.
    for f in range(7, len(frames)):
        d, v = pad_detections(dets[f], 8)
        out = sup.step(frames[f], d, v)
    assert int(out.n_alive) >= 4
    assert sup.failures == 1


def test_supervisor_skips_a_poisoned_frame():
    """A NaN frame is an input fault: the stream keeps its snapshot and
    emits an output without valid tracks; the next frame tracks again."""
    frames, dets = _scene()
    sup = StreamSupervisor(_cfg(n_init=1), snapshot_every=1, device="cpu")
    for f in range(4):
        d, v = pad_detections(dets[f], 8)
        sup.step(frames[f], d, v)
    d, v = pad_detections(dets[4], 8)
    bad = np.full_like(frames[4], np.nan)
    d_bad = d.copy()
    d_bad[:, :4] = np.nan
    out = sup.step(bad, d_bad, v)
    assert sup.failures == 1 and output_healthy(out, (120, 160))
    out = sup.step(frames[5], *pad_detections(dets[5], 8))
    assert sup.failures == 1 and int(out.n_alive) >= 4


def test_supervisor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert StreamSupervisor(_cfg()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            StreamSupervisor(_cfg())


def test_output_healthy_flags_nans_and_agrees_with_jax():
    frames, dets = _scene(2)
    jcfg, tcfg = both_configs(max_tracks=8, max_detections=8,
                              frame_height=120, frame_width=160, n_init=1)
    d, v = pad_detections(dets[0], 8)
    sup = StreamSupervisor(tcfg, device="cpu")
    sup.step(frames[0], d, v)
    out = sup.step(frames[1], *pad_detections(dets[1], 8))
    assert out.valid.any()
    _, jout = j_step.step(j_bank.empty_bank(jcfg), jnp.asarray(frames[0]),
                          jnp.asarray(d), jnp.asarray(v), jcfg)
    assert output_healthy(out, (120, 160))
    boxes = out.boxes.clone()
    boxes[0, 0] = float("nan")
    far = out.boxes.clone()
    far[out.valid.nonzero()[0, 0], 0] = 1e5
    for boxes_case, healthy in ((out.boxes, True), (boxes, False),
                                (far, False)):
        case = out._replace(boxes=boxes_case)
        jcase = jout._replace(boxes=jnp.asarray(boxes_case.numpy()),
                              valid=jnp.asarray(out.valid.numpy()))
        assert output_healthy(case, (120, 160)) is healthy
        assert j_sup.output_healthy(jcase, (120, 160)) is healthy


def test_fault_injection_hooks():
    """detections_from_gt exposes drop/false-positive injection."""
    rng = np.random.default_rng(1)
    objs = synthetic.make_objects(6, 120, 160, rng)
    _, boxes, vis = synthetic.render_sequence(objs, 20, 120, 160, seed=1)
    clean = synthetic.detections_from_gt(boxes, vis, seed=1,
                                         frame_hw=(120, 160))
    faulty = synthetic.detections_from_gt(boxes, vis, seed=1,
                                          drop_prob=0.5, fp_per_frame=2.0,
                                          frame_hw=(120, 160))
    assert sum(len(d) for d in faulty) != sum(len(d) for d in clean)


def test_device_timer_and_fps_meter():
    with DeviceTimer() as t:
        x = torch.ones((256, 256)) @ torch.ones((256, 256))
        t.observe({"x": [x]})
    assert t.elapsed > 0
    m = FpsMeter()
    for _ in range(5):
        m.tick(2)
    assert m.n_frames == 10
    assert m.stats()["frames"] == 10 and m.fps > 0


def test_trace_and_summary(tmp_path):
    """trace() writes a Chrome trace; summarize_trace sums the device
    kernels of the newest trace by name (a CPU-only trace has none)."""
    with profiling.trace(str(tmp_path / "cpu")):
        torch.ones((64, 64)) @ torch.ones((64, 64))
    assert (tmp_path / "cpu" / profiling.TRACE_NAME).exists()
    if not torch.cuda.is_available():
        assert profiling.summarize_trace(str(tmp_path / "cpu")) == []
    events = [
        {"ph": "X", "cat": "kernel", "name": "roi_kernel", "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": "roi_kernel", "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "auction_kernel", "dur": 9.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "dur": 70.0}]
    (tmp_path / "dev").mkdir()
    (tmp_path / "dev" / "trace.json").write_text(
        json.dumps({"traceEvents": events}))
    assert profiling.summarize_trace(str(tmp_path / "dev"), top=2) == [
        ("auction_kernel", 0.009, 1), ("roi_kernel", 0.007, 2)]
    assert profiling.summarize_trace(str(tmp_path / "none")) == []
