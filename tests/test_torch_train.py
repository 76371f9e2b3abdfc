"""The port's detector training (tpu_mot_torch.parallel.train and the train
mode of models/yolo.py) against the JAX package's (tpu_mot.parallel.train)
on the CPU, from the same weights (interop.numpy_yolo_params) and batches.

Tolerances:
  build_targets                 equal (collisions and off-frame boxes too);
  loss, float32                 1e-5 relative (measured <= 7.6e-7);
  gradients, float32            every leaf within 1e-4 of its largest
                                magnitude (measured <= 1.6e-5);
  running statistics            1e-5 after one train step (measured 9e-7);
  3 Adam steps                  parameters rtol 1e-3 / atol 3e-4
                                (tests/test_parallel.py:130's) for all but
                                1e-4 of the elements (measured 77-124 of
                                11M: Adam's ~lr move on a gradient of
                                undetermined sign), every element within
                                2 lr a step; step 0's loss 1e-5
                                relative, later steps' 5e-4 (measured
                                8.8e-5), each running-statistics vector
                                within 1e-3 relative (L2; the statistics
                                of parameters that are apart by as much;
                                measured <= 3.2e-4);
  bfloat16                      the loss and every gradient leaf no farther
                                from JAX's float32 result (L2) than 1.5x
                                JAX's own bfloat16 result is, plus 0.1%
                                (loss) or 1% (leaf) of its size: at random
                                weights a bfloat16 gradient sits 3-60% (L2)
                                from the float32 one in BOTH packages
                                (rounding of every activation), so
                                elementwise parity is not defined (measured
                                ratio <= 1.27);
  the dump at 416 (2 scenes)    the port's resize of the scenes within
                                1e-4 of the dump's images (XLA's CPU resize
                                and torch's antialiased bilinear differ by
                                up to 3.9e-5); on the dump's images, the loss
                                1e-5 relative and every gradient leaf's norm
                                5e-3 relative: at this depth and width a
                                float32 gradient norm of the first blocks is
                                only known to ~1e-3 (each package's float32
                                norms against the float64 ones (the port's
                                net in float64): within 3e-3, asserted;
                                on these 2 scenes: JAX 1.4e-3, the port
                                1.2e-3).

`python tests/test_torch_train.py regen-train-dump` rewrites
tests/golden/train_jax_v1.npz (JAX on the CPU, ~1 min), which
chip_smoke.py's train phase holds the card to.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from tpu_mot.models import yolo as j_yolo  # noqa: E402
from tpu_mot.parallel import train as j_train  # noqa: E402
from tpu_mot_torch import interop  # noqa: E402
from tpu_mot_torch.models import yolo as t_yolo  # noqa: E402
from tpu_mot_torch.parallel import train as t_train  # noqa: E402

torch.set_num_threads(2)


def both_specs(name, **kw):
    return j_yolo.YoloSpec(name, **kw), t_yolo.YoloSpec(name, **kw)


def jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def adam(params):
    return torch.optim.Adam(params, lr=1e-3)


def port_state(spec, tree):
    return t_train.train_state_from_params(
        spec, adam, interop.yolo_params_from_jax(tree), device="cpu")


def random_batch(spec, b=4, m=6, seed=0):
    """Images [b, s, s, 3] and GT with off-frame centres and a forced
    collision (two GTs of one image on the same cell and anchor)."""
    rng = np.random.default_rng(seed)
    s = spec.input_size
    images = rng.random((b, s, s, 3)).astype(np.float32)
    gb = np.zeros((b, m, 4), np.float32)
    gb[..., :2] = rng.uniform(-3, s + 3, (b, m, 2))
    gb[..., 2:] = rng.uniform(4, 0.8 * s, (b, m, 2))
    gb[0, 1] = gb[0, 0] + np.float32([0.5, 0.5, 0.0, 0.0])
    gc = rng.integers(0, spec.num_classes, (b, m))
    gv = rng.random((b, m)) > 0.2
    gv[0, :2] = True
    return images, gb, gc, gv


def grad_leaves(model):
    return {n: p.grad.detach().numpy() for n, p in model.named_parameters()}


def stats_of(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if "running" in k}


def jax_stats(params, batch_stats):
    sd = interop.yolo_params_from_jax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, batch_stats)})
    return {k: v.numpy() for k, v in sd.items() if "running" in k}


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(name, dtype, size, train=True):
    """JAX's loss, gradients (state-dict names, OIHW) and, in train mode,
    the updated running statistics on random_batch at seed 0."""
    js, ts = both_specs(name, num_classes=3, input_size=size, dtype=dtype,
                        bn_momentum=0.9)
    tree = interop.numpy_yolo_params(ts, 1)
    images, gb, gc, gv = random_batch(ts)
    tgt = [jnp.asarray(t) for t in j_train.build_targets(js, gb, gc, gv)]
    fn = jax.value_and_grad(j_train.yolo_loss, has_aux=train)
    out, grads = fn(jt(tree["params"]), jt(tree["batch_stats"]),
                    jnp.asarray(images), tgt, js, train)
    loss, stats = out if train else (out, None)
    g = {k: v.numpy() for k, v in interop._param_leaves(
        jax.tree.map(np.asarray, grads)).items()}
    return (float(loss), g,
            jax_stats(tree["params"], stats) if train else None)


def port_value_and_grad(name, dtype, size, train=True):
    ts = t_yolo.YoloSpec(name, num_classes=3, input_size=size, dtype=dtype,
                         bn_momentum=0.9)
    model = t_yolo.build_model(ts)
    model.load_state_dict(interop.yolo_params_from_jax(
        interop.numpy_yolo_params(ts, 1)))
    images, gb, gc, gv = random_batch(ts)
    loss = t_train.yolo_loss(model, torch.as_tensor(images),
                             t_train.build_targets(ts, gb, gc, gv), ts,
                             train=train)
    loss.backward()
    return float(loss.detach()), grad_leaves(model), stats_of(model), model


def test_build_targets_matches_jax():
    for name, nc, size in (("yolov2-tiny", 3, 64), ("yolov3-tiny", 5, 96)):
        js, ts = both_specs(name, num_classes=nc, input_size=size)
        for seed in range(3):
            _, gb, gc, gv = random_batch(ts, b=5, m=9, seed=seed)
            got = t_train.build_targets(ts, gb, gc, gv)
            want = j_train.build_targets(js, gb, gc, gv)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    # The collision: one (cell, anchor), the later GT's box, both classes.
    js, ts = both_specs("yolov2-tiny", num_classes=3, input_size=64)
    gb = np.float32([[[40, 40, 20, 20], [41, 41, 20, 20]]])
    gc = np.int64([[0, 2]])
    gv = np.ones((1, 2), bool)
    (t,) = t_train.build_targets(ts, gb, gc, gv)
    cell = t[0, 1, 1][t[0, 1, 1, :, 4] == 1][0]
    np.testing.assert_allclose(cell[:2], [41 / 32 - 1, 41 / 32 - 1])
    np.testing.assert_array_equal(cell[5:], [1, 0, 1])
    np.testing.assert_array_equal(t, j_train.build_targets(js, gb, gc,
                                                           gv)[0])


@pytest.mark.parametrize("name", ["yolov2-tiny", "yolov3-tiny"])
def test_loss_and_gradients_match_jax_f32(name):
    jl, jg, _ = jax_value_and_grad(name, "float32", 96)
    tl, tg, _, _ = port_value_and_grad(name, "float32", 96)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for k in jg:
        err = np.abs(tg[k] - jg[k]).max() / np.abs(jg[k]).max()
        assert err <= 1e-4, (k, err)


def test_eval_mode_loss_matches_jax():
    """train=False: BatchNorm with the running statistics (which stay)."""
    jl, jg, _ = jax_value_and_grad("yolov2-tiny", "float32", 96, False)
    tl, tg, stats, _ = port_value_and_grad("yolov2-tiny", "float32", 96,
                                           False)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    for k in jg:
        assert np.abs(tg[k] - jg[k]).max() <= 1e-4 * np.abs(jg[k]).max(), k
    ts = t_yolo.YoloSpec("yolov2-tiny", num_classes=3, input_size=96)
    init = interop.yolo_params_from_jax(interop.numpy_yolo_params(ts, 1))
    for k, v in stats.items():
        np.testing.assert_array_equal(v, init[k].numpy())


@pytest.mark.parametrize("name", ["yolov2-tiny", "yolov3-tiny"])
def test_loss_and_gradients_match_jax_bf16(name):
    ref_l, ref, _ = jax_value_and_grad(name, "float32", 96)
    jl, jg, _ = jax_value_and_grad(name, "bfloat16", 96)
    tl, tg, _, _ = port_value_and_grad(name, "bfloat16", 96)
    assert abs(tl - ref_l) <= 1.5 * abs(jl - ref_l) + 1e-3 * abs(ref_l), (
        tl, jl, ref_l)
    for k in ref:
        n_ref = np.linalg.norm(ref[k])
        jax_off = np.linalg.norm(jg[k] - ref[k])
        port_off = np.linalg.norm(tg[k] - ref[k])
        assert port_off <= 1.5 * jax_off + 0.01 * n_ref, (k, port_off,
                                                          jax_off, n_ref)


def test_running_statistics_after_a_step():
    """flax's update: biased batch variance, momentum 0.9 here.  The
    unbiased variance (torch's own BatchNorm update) would miss by far more
    than the tolerance, which the last assertion shows."""
    _, _, jstats = jax_value_and_grad("yolov2-tiny", "float32", 96)
    _, _, tstats, model = port_value_and_grad("yolov2-tiny", "float32", 96)
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    # ConvBlock_7 sees a 3x3 map of 4 images: n/(n-1) = 36/35.
    ts = model.spec
    init = interop.yolo_params_from_jax(interop.numpy_yolo_params(ts, 1))
    k = "ConvBlock_7.bn.running_var"
    batch_var = (jstats[k] - 0.9 * init[k].numpy()) / 0.1
    unbiased = 0.9 * init[k].numpy() + 0.1 * batch_var * 36 / 35
    assert np.abs(unbiased - jstats[k]).max() > 100 * 1e-5


@functools.lru_cache(maxsize=None)
def jax_adam_run(n_steps=4):
    """JAX's train state and loss after each of n_steps optax.adam(1e-3)
    steps of yolov2-tiny at 64 (3 classes, momentum 0.9)."""
    js, ts = both_specs("yolov2-tiny", num_classes=3, input_size=64,
                        bn_momentum=0.9)
    tree = interop.numpy_yolo_params(ts, 2)
    images, gb, gc, gv = random_batch(ts, seed=3)
    tgt = [jnp.asarray(t) for t in j_train.build_targets(js, gb, gc, gv)]
    tx = optax.adam(1e-3)
    params = jt(tree["params"])
    state = (params, jt(tree["batch_stats"]), tx.init(params))
    step = j_train.make_train_step(js, tx)
    states, losses = [], []
    for _ in range(n_steps):
        state, loss = step(state, jnp.asarray(images), tgt)
        states.append(jax.tree.map(np.asarray, state))
        losses.append(float(loss))
    return ts, tree, (images, gb, gc, gv), states, losses


def assert_params_close(model, jstate, n_steps):
    """rtol 1e-3 / atol 3e-4 for all but 1e-4 of the elements, and every
    element within 2 * lr a step: Adam moves an element by ~lr whatever its
    gradient's size, so a gradient at float32's rounding noise (an
    undetermined sign) moves it either way (77-124 of 11M here)."""
    want = interop._param_leaves(jstate[0])
    n_off = n_all = 0
    for n, p in model.named_parameters():
        got, w = p.detach().numpy(), want[n].numpy()
        diff = np.abs(got - w)
        n_off += int((diff > 3e-4 + 1e-3 * np.abs(w)).sum())
        n_all += diff.size
        assert diff.max() <= 2e-3 * n_steps + 1e-6, (n, diff.max())
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def test_three_adam_steps_match_optax():
    ts, tree, (images, gb, gc, gv), states, losses = jax_adam_run()
    state = port_state(ts, tree)
    step = t_train.make_train_step(ts)
    tgt = t_train.build_targets(ts, gb, gc, gv)
    for i in range(3):
        state, loss = step(state, torch.as_tensor(images), tgt)
        assert abs(float(loss) - losses[i]) <= (1e-5 if i == 0 else 5e-4) * \
            abs(losses[i]), i
    assert_params_close(state.model, states[2], 3)
    want = jax_stats(*states[2][:2])
    for k, v in stats_of(state.model).items():
        rel = np.linalg.norm(v - want[k]) / np.linalg.norm(want[k])
        assert rel <= 1e-3, (k, rel)


def test_resume_from_jax_step_three():
    """yolo_train_state_from_jax: the port continues JAX's Adam run (its
    moments and step count) and lands on JAX's step 4."""
    ts, _, (images, gb, gc, gv), states, losses = jax_adam_run()
    sd, adam_state = interop.yolo_train_state_from_jax(*states[2])
    assert all(float(v["step"]) == 3.0 for v in adam_state.values())
    state = t_train.train_state_from_params(ts, adam, sd, adam_state,
                                            device="cpu")
    state, loss = t_train.make_train_step(ts)(
        state, torch.as_tensor(images), t_train.build_targets(ts, gb, gc,
                                                              gv))
    assert abs(float(loss) - losses[3]) <= 1e-5 * abs(losses[3])
    assert_params_close(state.model, states[3], 1)
    for p in state.model.parameters():
        assert float(state.optimizer.state[p]["step"]) == 4.0


def toy_batch(rng, b=4, s=64):
    """tests/test_train.py's toy task: one bright rectangle an image."""
    images = rng.random((b, s, s, 3)).astype(np.float32) * 0.2
    gt_boxes = np.zeros((b, 1, 4), np.float32)
    for i in range(b):
        cx, cy = rng.uniform(16, 48, 2)
        w, h = rng.uniform(12, 20, 2)
        x0, x1 = int(cx - w / 2), int(cx + w / 2)
        y0, y1 = int(cy - h / 2), int(cy + h / 2)
        images[i, y0:y1, x0:x1] = 0.9
        gt_boxes[i, 0] = (cx, cy, w, h)
    return (images, gt_boxes, np.zeros((b, 1), int), np.ones((b, 1), bool))


def test_loss_decreases():
    """tests/test_train.py::test_loss_decreases on the port (its own
    initialisation: init_train_state)."""
    spec = t_yolo.YoloSpec("yolov2-tiny", num_classes=1, input_size=64)
    state = t_train.init_train_state(spec, adam, seed=0, device="cpu")
    step = t_train.make_train_step(spec)
    images, gb, gc, gv = toy_batch(np.random.default_rng(0))
    tgt = t_train.build_targets(spec, gb, gc, gv)
    losses = [float(step(state, torch.as_tensor(images), tgt)[1])
              for _ in range(25)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_init_train_state():
    """An explicit generator: the same seed gives the same weights, another
    seed others; flax's scheme (truncated lecun-normal, BN identity)."""
    spec = t_yolo.YoloSpec("yolov2-tiny", num_classes=2, input_size=64)
    a = t_train.init_params(spec, 0)
    b = t_train.init_params(spec, 0)
    c = t_train.init_params(spec, 1)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    w = a["ConvBlock_5.conv.weight"]
    std = (1.0 / (9 * w.shape[1])) ** 0.5
    assert not torch.equal(w, c["ConvBlock_5.conv.weight"])
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(a["ConvBlock_5.bn.running_var"], torch.ones(512))
    state = t_train.init_train_state(spec, adam, seed=0, device="cpu")
    assert not state.model.training
    assert isinstance(state.optimizer, torch.optim.Adam)


def test_int8_refused():
    spec = t_yolo.YoloSpec("yolov2-tiny", input_size=64, dtype="int8")
    with pytest.raises(ValueError, match="inference-only"):
        t_train.init_train_state(spec, adam, device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        j_train.init_train_state(j_yolo.YoloSpec(
            "yolov2-tiny", input_size=64, dtype="int8"), optax.adam(1e-3))


def test_train_state_checkpoint_resumes(tmp_path):
    """save_train_state after 2 steps, load into a fresh state: 2 more
    steps equal the uninterrupted run's bit for bit."""
    spec = t_yolo.YoloSpec("yolov2-tiny", num_classes=3, input_size=64)
    images, gb, gc, gv = random_batch(spec, seed=4)
    x, tgt = torch.as_tensor(images), t_train.build_targets(spec, gb, gc,
                                                            gv)
    step = t_train.make_train_step(spec)
    a = t_train.init_train_state(spec, adam, seed=3, device="cpu")
    for _ in range(2):
        step(a, x, tgt)
    t_train.save_train_state(str(tmp_path / "ckpt"), a)
    b = t_train.load_train_state(
        str(tmp_path / "ckpt"),
        t_train.init_train_state(spec, adam, seed=9, device="cpu"))
    for _ in range(2):
        la = step(a, x, tgt)[1]
        lb = step(b, x, tgt)[1]
        assert torch.equal(la, lb)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_train_dump_two_scenes_at_416():
    """The dump's first 2 scenes at full width (yolov3-tiny, 80 classes,
    416): step 0's loss and every gradient leaf's norm against JAX's."""
    with np.load(chip_smoke.TRAIN_DUMP) as dump:
        gray = dump["images"][:2]
        want_loss = float(dump["b2_loss0"])
        want = {k[len("b2_grad_norm/"):]: float(dump[k]) for k in dump.files
                if k.startswith("b2_grad_norm/")}
    spec = t_yolo.YoloSpec(**chip_smoke.TRAIN_SPEC)
    frames, boxes, classes, vis = chip_smoke.train_scenes(2)
    images = chip_smoke.train_images(frames)
    assert np.abs(images[..., 0].numpy() - gray).max() <= 1e-4
    model = t_yolo.build_model(spec)
    model.load_state_dict(interop.yolo_params_from_jax(
        interop.numpy_yolo_params(spec, 0)))
    loss = t_train.yolo_loss(
        model, torch.as_tensor(gray)[..., None].repeat(1, 1, 1, 3),
        t_train.build_targets(spec, boxes, classes, vis), spec, train=True)
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    got = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
    model = model.double()
    model.zero_grad()
    t_train.yolo_loss(
        model, torch.as_tensor(gray, dtype=torch.float64)[..., None].repeat(
            1, 1, 1, 3),
        [torch.as_tensor(t, dtype=torch.float64) for t in
         t_train.build_targets(spec, boxes, classes, vis)], spec,
        train=True).backward()
    exact = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 5e-3 * want[k], (k, got[k], want[k])
        assert abs(got[k] - exact[k]) <= 3e-3 * exact[k], k
        assert abs(want[k] - exact[k]) <= 3e-3 * exact[k], k


def regen_train_dump():
    """JAX's training on chip_smoke's batch -> tests/golden/train_jax_v1.npz
    (see chip_smoke.TRAIN_DUMP)."""
    js, ts = both_specs(**chip_smoke.TRAIN_SPEC)
    tree = interop.numpy_yolo_params(ts, 0)
    frames, boxes, classes, vis = chip_smoke.train_scenes()
    s = ts.input_size
    gray = jax.image.resize(jnp.asarray(frames), (len(frames), s, s),
                            "bilinear")
    images = gray[..., None].repeat(3, -1)
    out = {"images": np.asarray(gray)}
    tgt = [jnp.asarray(t) for t in j_train.build_targets(js, boxes, classes,
                                                         vis)]
    vg = jax.value_and_grad(j_train.yolo_loss, has_aux=True)
    for prefix, n in (("", len(frames)), ("b2_", 2)):
        (loss, stats), grads = vg(jt(tree["params"]),
                                  jt(tree["batch_stats"]), images[:n],
                                  [t[:n] for t in tgt], js, True)
        g = interop._param_leaves(jax.tree.map(np.asarray, grads))
        out[prefix + "loss0"] = np.float32(loss)
        if not prefix:
            for k, v in jax_stats(tree["params"], stats).items():
                out[f"stats0/{k}"] = v
        for k, v in g.items():
            out[f"{prefix}grad_norm/{k}"] = np.float32(np.linalg.norm(v))
            if not prefix and k.startswith("head"):
                out[f"grad/{k}"] = v.numpy()
    # The exact norms: the port in float64 on the CPU, same batch.
    model = t_yolo.build_model(ts).double()
    model.load_state_dict(interop.yolo_params_from_jax(tree))
    t_train.yolo_loss(model, torch.as_tensor(np.asarray(images),
                                             dtype=torch.float64),
                      [torch.as_tensor(np.asarray(t), dtype=torch.float64)
                       for t in tgt], ts, train=True).backward()
    for n, p in model.named_parameters():
        out[f"grad_norm64/{n}"] = np.float64(p.grad.norm())
    tx = optax.adam(chip_smoke.TRAIN_LR)
    params = jt(tree["params"])
    state = (params, jt(tree["batch_stats"]), tx.init(params))
    step = j_train.make_train_step(js, tx)
    losses = []
    for _ in range(chip_smoke.TRAIN_STEPS):
        state, loss = step(state, images, tgt)
        losses.append(float(loss))
    out["losses"] = np.float32(losses)
    for k, v in jax_stats(*state[:2]).items():
        out[f"stats/{k}"] = v
    np.savez_compressed(chip_smoke.TRAIN_DUMP, **out)
    print(f"wrote {chip_smoke.TRAIN_DUMP}: loss0 {float(out['loss0'])}, "
          f"losses {losses}")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen-train-dump"]:
        jax.config.update("jax_platforms", "cpu")
        regen_train_dump()
    else:
        sys.exit("usage: python tests/test_torch_train.py regen-train-dump")
