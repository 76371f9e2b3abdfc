"""The port's multi-device paths (tpu_mot_torch.parallel.mesh, the mesh
arguments of parallel/serve.py, the data-parallel train step, the dry run)
against the JAX package's meshes on the CPU.

The port runs in 4 gloo ranks (mesh.spawn, one thread each); the JAX
package on 4 of the 8 virtual CPU devices that tests/conftest.py sets up.
Both get the same numpy inputs (the fixtures of tests/test_parallel.py) and
the same weights (interop.numpy_yolo_params).  Ranks return their blocks;
the test gathers them in rank order.

  (a) shard_leading gives the blocks of NamedSharding(P("stream")), and
      replicated gives rank 0's value;
  (b) multi_stream_step (2 frames) and multi_stream_sequence sharded over
      the ranks: ids equal and boxes within rtol 1e-5, atol 1e-4 of JAX's
      sharded run, and bit for bit the port's one-process run over all 8
      streams;
  (c) shared_detector_detect and multi_stream_sequence_strided with the
      mesh, class-blind and class-aware: the gathered detections bit for
      bit the one-process forward over all 8 frames, and within the
      detector tolerances of tests/test_torch_detector.py of JAX's shared
      detector (boxes rtol 1e-5 / atol 1e-3, scores 1e-5); the strided
      outputs bit for bit the one-process strided run and, ids, valid and
      classes equal and boxes within 0.05 px (tests/test_parallel.py's own
      tolerance), JAX's; the per-shard data-parallel mode (a forward of 2
      frames a rank) within 0.05 px of the shared mode;
  (d) the data-parallel train step on a global batch of 8 over 4 ranks:
      the loss within rtol 1e-4 of JAX's DP step and of the port's
      one-process step, running statistics within 1e-5, parameters after
      one step within rtol 1e-3 / atol 3e-4 (tests/test_parallel.py:130's),
      every rank's state bit-identical after 3 steps and at build (ranks
      built from different seeds get rank 0's); per-rank BatchNorm
      statistics (each rank normalising its own 2 images) miss the global
      ones by more than 1e-5, and a step without the gradient sum misses
      the parameters' tolerance, so the checks catch both traps;
  (e) dryrun_multichip(4, device="cpu");
  (f) what must raise: a mesh, spawn or dry run on "cuda" without a card,
      NCCL on the CPU, streams that the ranks do not divide, a failing
      rank.

JAX is imported inside the test functions only: spawned ranks import this
module to find their function, and a rank must never import JAX.
"""

import contextlib

import numpy as np
import pytest
import torch

from chip_smoke import state_digest
from tpu_mot_torch import interop
from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.models import detector as t_det
from tpu_mot_torch.models import yolo as t_yolo
from tpu_mot_torch.parallel import dryrun
from tpu_mot_torch.parallel import mesh as mesh_mod
from tpu_mot_torch.parallel import serve as t_serve
from tpu_mot_torch.parallel import train as t_train
from tpu_mot_torch.tracker.api import pad_detections

WORLD, N_STR = 4, 8

STEP_CFG = dict(max_tracks=16, max_detections=8, frame_height=80,
                frame_width=100, roi_impl="xla", n_init=1)
SEQ_CFG = dict(max_tracks=8, max_detections=4, frame_height=64,
               frame_width=64, roi_impl="xla", n_init=1, use_kcf=False)
DET_CFG = dict(max_tracks=8, max_detections=8, frame_height=96,
               frame_width=128, roi_impl="xla")
DET_CASES = {False: dict(classes=1, weights=0, frames=5),
             True: dict(classes=3, weights=3, frames=7)}
N_FRAMES, STRIDE = 6, 3
TRAIN_LR = 1e-2


# ---- fixtures, the same in the ranks and in the test ---------------------

def step_case():
    """tests/test_parallel.py:27-65 over 2 frames: random float frames
    [8, 2, 80, 100], the same two detections a stream on both frames."""
    rng = np.random.default_rng(0)
    frames = rng.random((N_STR, 2, 80, 100)).astype(np.float32)
    dets = np.zeros((N_STR, 2, 8, 5), np.float32)
    valid = np.zeros((N_STR, 2, 8), bool)
    for s in range(N_STR):
        raw = np.concatenate([rng.uniform(20, 80, (2, 2)),
                              rng.uniform(8, 16, (2, 2)),
                              np.ones((2, 1))], 1).astype(np.float32)
        for f in range(2):
            dets[s, f], valid[s, f] = pad_detections(raw, 8)
    return frames, dets, valid


def seq_case():
    """tests/test_parallel.py:68-88: noise frames [8, 5, 64, 64], one
    detection held still."""
    frames = np.random.default_rng(1).random(
        (N_STR, 5, 64, 64)).astype(np.float32)
    dets = np.tile(np.asarray([[32, 32, 12, 12, 1.0]], np.float32),
                   (N_STR, 5, 4, 1))
    valid = np.zeros((N_STR, 5, 4), bool)
    valid[:, :, 0] = True
    return frames, dets, valid


def det_spec(class_aware: bool) -> dict:
    """yolov2-tiny at 64 (tests/test_parallel.py:217-310): one class with
    the v2-tiny anchors, or three classes (weights from seed 3, whose
    detections above 0.2 hold all three classes)."""
    c = DET_CASES[class_aware]["classes"]
    kw = dict(anchors=t_yolo.YOLOV2_TINY_ANCHORS) if c == 1 else {}
    return dict(name="yolov2-tiny", num_classes=c, input_size=64, **kw)


def det_frames(class_aware: bool) -> np.ndarray:
    """Time-major float frames [6, 8, 96, 128]."""
    return np.random.default_rng(DET_CASES[class_aware]["frames"]).random(
        (N_FRAMES, N_STR, 96, 128)).astype(np.float32)


def det_model(class_aware: bool):
    spec = t_yolo.YoloSpec(**det_spec(class_aware))
    tree = interop.numpy_yolo_params(spec, DET_CASES[class_aware]["weights"])
    return t_det.YoloDetector(spec, interop.yolo_params_from_jax(tree),
                              device="cpu").model


def t_detect(model, frames):
    return t_det.detect_batch(model, frames, (96, 128), 8, 0.45, 0.2)


TRAIN_SPEC = dict(name="yolov2-tiny", num_classes=2, input_size=64,
                  anchors=t_yolo.YOLOV2_TINY_ANCHORS)


def train_case():
    """tests/test_parallel.py:91-131's batch of 8: images, targets'
    ground truth."""
    rng = np.random.default_rng(2)
    images = rng.random((8, 64, 64, 3)).astype(np.float32)
    gt_boxes = rng.uniform(8, 56, (8, 1, 4)).astype(np.float32)
    return images, gt_boxes, np.zeros((8, 1), int), np.ones((8, 1), bool)


def sgd(params):
    return torch.optim.SGD(params, lr=TRAIN_LR)


def _np_out(out) -> dict:
    return {k: getattr(out, k).cpu().numpy() for k in out._fields}


# ---- the ranks --------------------------------------------------------

def _ranks(rank: int, world: int) -> dict:
    """Everything (a)-(d) and (f) ask of the port, on this rank's blocks."""
    m = mesh_mod.stream_mesh(world, device="cpu")
    res = {}
    # (a)
    res["block"] = mesh_mod.shard_leading(
        torch.arange(N_STR * 3).reshape(N_STR, 3), m)
    res["replicated"] = mesh_mod.replicated(torch.full((2,), rank + 10.0), m)
    # (b)
    frames, dets, valid = (mesh_mod.shard_leading(torch.as_tensor(x), m)
                           for x in step_case())
    cfg = TrackerConfig(**STEP_CFG)
    banks = t_serve.make_stream_banks(N_STR, cfg, m, device="cpu")
    res["step"] = []
    for f in range(2):
        banks, out = t_serve.multi_stream_step(banks, frames[:, f],
                                               dets[:, f], valid[:, f], cfg)
        res["step"].append(_np_out(out))
    frames, dets, valid = (mesh_mod.shard_leading(torch.as_tensor(x), m)
                           for x in seq_case())
    cfg = TrackerConfig(**SEQ_CFG)
    res["sequence"] = _np_out(t_serve.multi_stream_sequence(
        t_serve.make_stream_banks(N_STR, cfg, m, device="cpu"), frames, dets,
        valid, cfg)[1])
    # (c)
    for aware in (False, True):
        model = det_model(aware)
        frames = torch.as_tensor(det_frames(aware)).transpose(0, 1)
        frames = mesh_mod.shard_leading(frames, m).transpose(0, 1)
        d, v = t_serve.shared_detector_detect(model, frames[0], t_detect, m,
                                              with_classes=True)
        cfg = TrackerConfig(class_aware=aware, **DET_CFG)
        res[f"detect {aware}"] = (d.numpy(), v.numpy())
        for mode, mm in (("shared", m), ("dp", None)):
            _, out = t_serve.multi_stream_sequence_strided(
                model, t_serve.make_stream_banks(N_STR, cfg, m, device="cpu"),
                frames, cfg, t_detect, STRIDE, mesh=mm)
            res[f"strided {mode} {aware}"] = _np_out(out)
    # (d)
    bm = mesh_mod.batch_mesh(world, device="cpu")
    spec = t_yolo.YoloSpec(**TRAIN_SPEC)
    params = interop.yolo_params_from_jax(interop.numpy_yolo_params(spec, 0))
    images, gb, gc, gv = train_case()
    x = mesh_mod.shard_leading(torch.as_tensor(images), bm)
    tgt = [mesh_mod.shard_leading(torch.as_tensor(t), bm)
           for t in t_train.build_targets(spec, gb, gc, gv)]
    state = t_train.train_state_from_params(spec, sgd, params, device="cpu",
                                            mesh=bm)
    step = t_train.make_train_step(spec, bm)
    state, loss = step(state, x, tgt)
    res["loss"] = float(loss)
    if rank == 0:
        res["after one step"] = {k: v.clone() for k, v in
                                 state.model.state_dict().items()}
    for _ in range(2):
        state, _ = step(state, x, tgt)
    res["digest after 3 steps"] = state_digest(state.model)
    res["digest at build"] = state_digest(t_train.init_train_state(
        spec, sgd, seed=rank, device="cpu", mesh=bm).model)
    local = t_train.train_state_from_params(spec, sgd, params, device="cpu")
    t_train.make_train_step(spec)(local, x, tgt)
    res["per-rank stats"] = {k: v for k, v in local.model.state_dict().items()
                             if "running" in k}
    unsummed = t_train.train_state_from_params(spec, sgd, params,
                                               device="cpu", mesh=bm)
    sum_gradients, t_train._sum_gradients = t_train._sum_gradients, (
        lambda model, mesh: None)
    try:
        step(unsummed, x, tgt)
    finally:
        t_train._sum_gradients = sum_gradients
    res["unsummed params"] = {k: v for k, v in
                              unsummed.model.state_dict().items()
                              if "running" not in k and "num_batches" not in k}
    # (f)
    try:
        t_serve.make_stream_banks(N_STR - 2, cfg, m, device="cpu")
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def _fail_on_rank_one(rank: int, world: int) -> None:
    m = mesh_mod.stream_mesh(world, device="cpu")
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh_mod.all_gather_leading(torch.zeros(1), m)   # rank 0 waits here


@pytest.fixture(scope="module")
def ranks():
    return mesh_mod.spawn(_ranks, WORLD, device="cpu")


def gathered(ranks, key, field=None):
    """The ranks' blocks of `key` concatenated in rank order."""
    parts = [r[key] if field is None else r[key][field] for r in ranks]
    return np.concatenate(parts)


@contextlib.contextmanager
def one_thread():
    """The ranks' thread count, so one-process runs compare bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---- the JAX side (imported here, never in a rank) ----------------------

def jax_mesh(axis="stream"):
    from tpu_mot.parallel import mesh as j_mesh
    return (j_mesh.stream_mesh(WORLD) if axis == "stream"
            else j_mesh.batch_mesh(WORLD))


def sharded(x, m, spec=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    return jax.device_put(jnp.asarray(x),
                          NamedSharding(m, P("stream") if spec is None
                                        else spec))


def jax_config(**kw):
    from tpu_mot.config import TrackerConfig as JConfig
    return JConfig(**kw)


def assert_tracks(got: dict, want, what, atol=1e-4, rtol=1e-5):
    np.testing.assert_array_equal(got["ids"], np.asarray(want.ids),
                                  err_msg=what)
    np.testing.assert_array_equal(got["valid"], np.asarray(want.valid),
                                  err_msg=what)
    np.testing.assert_allclose(got["boxes"], np.asarray(want.boxes),
                               rtol=rtol, atol=atol, err_msg=what)


def gathered_out(ranks, key, index=None) -> dict:
    parts = [r[key] if index is None else r[key][index] for r in ranks]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def assert_bit_equal(got: dict, want, what):
    for k in want._fields:
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy(),
                                      err_msg=f"{what}: {k}")


# ---- (a) ---------------------------------------------------------------

def test_shard_leading_gives_the_blocks_of_a_stream_sharding(ranks):
    x = np.arange(N_STR * 3).reshape(N_STR, 3)
    m = jax_mesh()
    arr = sharded(x, m)
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, dev in enumerate(m.devices.flat):
        np.testing.assert_array_equal(ranks[r]["block"].numpy(),
                                      by_device[dev])
    np.testing.assert_array_equal(gathered(ranks, "block"), x)


def test_replicated_gives_rank_zeros_value(ranks):
    for r in ranks:
        assert torch.equal(r["replicated"], torch.full((2,), 10.0))


# ---- (b) ---------------------------------------------------------------

def test_sharded_multi_stream_step(ranks):
    from tpu_mot.parallel import serve as j_serve
    frames, dets, valid = step_case()
    m = jax_mesh()
    jcfg = jax_config(**STEP_CFG)
    jbanks = j_serve.make_stream_banks(N_STR, jcfg, m)
    cfg = TrackerConfig(**STEP_CFG)
    with one_thread():
        banks = t_serve.make_stream_banks(N_STR, cfg, device="cpu")
        for f in range(2):
            got = gathered_out(ranks, "step", f)
            jbanks, jout = j_serve.multi_stream_step(
                jbanks, sharded(frames[:, f], m), sharded(dets[:, f], m),
                sharded(valid[:, f], m), jcfg)
            assert_tracks(got, jout, f"frame {f} against JAX")
            banks, one = t_serve.multi_stream_step(
                banks, torch.as_tensor(frames[:, f]),
                torch.as_tensor(dets[:, f]), torch.as_tensor(valid[:, f]),
                cfg)
            assert_bit_equal(got, one, f"frame {f} against one process")
    assert got["valid"].any()


def test_sharded_multi_stream_sequence(ranks):
    from tpu_mot.parallel import serve as j_serve
    frames, dets, valid = step = seq_case()
    m = jax_mesh()
    jcfg = jax_config(**SEQ_CFG)
    _, jout = j_serve.multi_stream_sequence(
        j_serve.make_stream_banks(N_STR, jcfg, m),
        *(sharded(x, m) for x in step), jcfg)
    got = gathered_out(ranks, "sequence")
    assert got["ids"].shape == (N_STR, 5, 8)
    assert_tracks(got, jout, "against JAX")
    cfg = TrackerConfig(**SEQ_CFG)
    with one_thread():
        _, one = t_serve.multi_stream_sequence(
            t_serve.make_stream_banks(N_STR, cfg, device="cpu"),
            *(torch.as_tensor(x) for x in step), cfg)
    assert_bit_equal(got, one, "against one process")
    assert (got["n_alive"][:, -1] == 1).all()


# ---- (c) ---------------------------------------------------------------

def jax_detector(class_aware: bool):
    import functools

    import jax
    import jax.numpy as jnp
    from tpu_mot.models import detector as j_det
    from tpu_mot.models import yolo as j_yolo
    spec = j_yolo.YoloSpec(**det_spec(class_aware))
    tree = interop.numpy_yolo_params(t_yolo.YoloSpec(**det_spec(
        class_aware)), DET_CASES[class_aware]["weights"])
    fn = functools.partial(j_det.detect_batch, spec=spec,
                           frame_hw=(96, 128), max_out=8, iou_thr=0.45,
                           score_thr=0.2)
    return jax.tree.map(jnp.asarray, tree), fn


@pytest.mark.parametrize("class_aware", [False, True])
def test_shared_detector_detect(ranks, class_aware):
    from tpu_mot.parallel import serve as j_serve
    frames = det_frames(class_aware)[0]
    d = gathered(ranks, f"detect {class_aware}", 0)
    v = gathered(ranks, f"detect {class_aware}", 1)
    with one_thread():
        od, ov = t_serve.shared_detector_detect(
            det_model(class_aware), torch.as_tensor(frames), t_detect,
            with_classes=True)
    np.testing.assert_array_equal(d, od.numpy())
    np.testing.assert_array_equal(v, ov.numpy())
    assert v.any()
    params, fn = jax_detector(class_aware)
    m = jax_mesh()
    jd, jv = j_serve.shared_detector_detect(
        params, sharded(frames, m), m,
        lambda p, fr: fn(p, fr), with_classes=True)
    jd, jv = np.asarray(jd), np.asarray(jv)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(d[..., :4][v], jd[..., :4][v], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(d[..., 4][v], jd[..., 4][v], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(d[..., 5][v], jd[..., 5][v])


@pytest.mark.parametrize("class_aware", [False, True])
def test_strided_serving_over_the_mesh(ranks, class_aware):
    """tests/test_parallel.py:217-310's mesh mode."""
    from jax.sharding import PartitionSpec as P
    from tpu_mot.parallel import serve as j_serve
    frames = det_frames(class_aware)
    shared = gathered_out(ranks, f"strided shared {class_aware}")
    dp = gathered_out(ranks, f"strided dp {class_aware}")
    cfg = TrackerConfig(class_aware=class_aware, **DET_CFG)
    with one_thread():
        _, one = t_serve.multi_stream_sequence_strided(
            det_model(class_aware),
            t_serve.make_stream_banks(N_STR, cfg, device="cpu"),
            torch.as_tensor(frames), cfg, t_detect, STRIDE)
    assert_bit_equal(shared, one, "shared against one process")
    assert_tracks(dp, one, "data-parallel against shared", atol=0.05, rtol=0)
    np.testing.assert_array_equal(dp["cls"], one.cls.numpy())
    params, fn = jax_detector(class_aware)
    m = jax_mesh()
    jcfg = jax_config(class_aware=class_aware, **DET_CFG)
    _, jout = j_serve.multi_stream_sequence_strided(
        params, j_serve.make_stream_banks(N_STR, jcfg, m),
        sharded(frames, m, P(None, "stream")), jcfg, fn, STRIDE, mesh=m)
    assert_tracks(shared, jout, "against JAX", atol=0.05, rtol=0)
    np.testing.assert_array_equal(shared["cls"], np.asarray(jout.cls))
    alive = shared["ids"] >= 0
    assert alive.any()
    if class_aware:
        assert len(set(shared["cls"][alive].tolist())) > 1


# ---- (d) ---------------------------------------------------------------

def one_process_step():
    spec = t_yolo.YoloSpec(**TRAIN_SPEC)
    images, gb, gc, gv = train_case()
    state = t_train.train_state_from_params(
        spec, sgd, interop.yolo_params_from_jax(
            interop.numpy_yolo_params(spec, 0)), device="cpu")
    state, loss = t_train.make_train_step(spec)(
        state, torch.as_tensor(images), t_train.build_targets(spec, gb, gc,
                                                              gv))
    return float(loss), state.model.state_dict()


def jax_dp_step():
    """JAX's step on the batch mesh: params and statistics as a port state
    dict, and the loss."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpu_mot.models import yolo as j_yolo
    from tpu_mot.parallel import train as j_train
    spec = j_yolo.YoloSpec(**TRAIN_SPEC)
    tree = interop.numpy_yolo_params(t_yolo.YoloSpec(**TRAIN_SPEC), 0)
    tx = optax.sgd(TRAIN_LR)
    params = jax.tree.map(jnp.asarray, tree["params"])
    m = jax_mesh("batch")
    rep, bsh = NamedSharding(m, P()), NamedSharding(m, P("batch"))
    state = jax.device_put(
        (params, jax.tree.map(jnp.asarray, tree["batch_stats"]),
         tx.init(params)), rep)
    images, gb, gc, gv = train_case()
    (p, stats, _), loss = j_train.make_train_step(spec, tx)(
        state, jax.device_put(jnp.asarray(images), bsh),
        [jax.device_put(jnp.asarray(t), bsh)
         for t in j_train.build_targets(spec, gb, gc, gv)])
    sd = interop.yolo_params_from_jax(
        {"params": jax.tree.map(np.asarray, p),
         "batch_stats": jax.tree.map(np.asarray, stats)})
    return float(loss), sd


def test_dp_train_step_is_the_global_batch_step(ranks):
    losses = [r["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses
    got = ranks[0]["after one step"]
    with one_thread():
        one_loss, one = one_process_step()
    j_loss, jsd = jax_dp_step()
    for what, loss, ref in (("one process", one_loss, one),
                            ("JAX DP", j_loss, jsd)):
        np.testing.assert_allclose(losses[0], loss, rtol=1e-4, err_msg=what)
        for k, v in ref.items():
            if "num_batches" in k:
                continue
            if "running" in k:
                np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{what}: {k}")
            else:
                np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                           rtol=1e-3, atol=3e-4,
                                           err_msg=f"{what}: {k}")


def test_dp_replicas_stay_bit_identical(ranks):
    assert len({r["digest after 3 steps"] for r in ranks}) == 1
    # ranks built from seeds 0-3 all hold rank 0's state (seed 0)
    spec = t_yolo.YoloSpec(**TRAIN_SPEC)
    want = t_train.init_train_state(spec, sgd, seed=0, device="cpu")
    assert {r["digest at build"] for r in ranks} == {state_digest(want.model)}


def test_per_rank_statistics_fail_the_statistics_check(ranks):
    """The trap the global statistics avoid: a rank normalising its own 2
    images moves the running statistics by far more than the 1e-5 that
    test_dp_train_step_is_the_global_batch_step allows."""
    with one_thread():
        _, one = one_process_step()
    for r in ranks:
        worst = max(float((v - one[k]).abs().max())
                    for k, v in r["per-rank stats"].items())
        assert worst > 100 * 1e-5, worst


def test_a_missing_gradient_sum_fails_the_parameter_check(ranks):
    """Without the gradient all-reduce each rank steps on the gradient of
    its own share of the loss: every rank's parameters then miss the
    one-process step's by more than the rtol 1e-3 / atol 3e-4 that
    test_dp_train_step_is_the_global_batch_step allows."""
    with one_thread():
        _, one = one_process_step()
    for r in ranks:
        worst = max(float(((v - one[k]).abs()
                           - 1e-3 * one[k].abs()).max())
                    for k, v in r["unsummed params"].items())
        assert worst > 10 * 3e-4, worst


# ---- (e) ---------------------------------------------------------------

def test_dryrun_multichip_on_cpu_ranks():
    out = dryrun.dryrun_multichip(WORLD, device="cpu")
    assert [r["rank"] for r in out] == list(range(WORLD))
    assert {r["backend"] for r in out} == {"gloo"}
    assert all(r["n_alive"] == [3] for r in out)
    assert len({r["loss"] for r in out}) == 1


# ---- (f) ---------------------------------------------------------------

def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for call in (lambda: mesh_mod.stream_mesh(),
                 lambda: mesh_mod.batch_mesh(device="cuda"),
                 lambda: mesh_mod.spawn(_fail_on_rank_one, 2, device="cuda"),
                 lambda: dryrun.dryrun_multichip(2),
                 lambda: t_serve.dryrun_shared_detector(None)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_refusals():
    with pytest.raises(ValueError, match="NCCL runs between cards"):
        mesh_mod.spawn(_fail_on_rank_one, 2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        mesh_mod.stream_mesh(device="cpu", backend="mpi")


def test_streams_the_ranks_do_not_divide_raise(ranks):
    for r in ranks:
        assert "6 streams do not split over the 4 ranks" in r["indivisible"]


def test_a_failing_rank_fails_spawn():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        mesh_mod.spawn(_fail_on_rank_one, 2, device="cpu")
