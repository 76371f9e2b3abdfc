"""Converters between the JAX package's values and the port's.

The JAX package keeps spectra as split-complex CF pairs (re, im) of
float32; the port keeps complex64.  A JAX TrackBank converts to the port's
bank and back field by field, so both packages can start from the same
mid-sequence bank; so does the single-object flow's KCFBank.  YOLO
parameters convert between the flax tree ({"params", "batch_stats"} of
nested dicts, HWIO kernels) and the port's state dict (OIHW), and
`numpy_yolo_params` draws a flax-layout tree from a NumPy seed, so both
packages can run the same weights without JAX on the card; a JAX training
state (params, batch_stats and optax.adam's moments) converts into a state
dict and torch.optim.Adam's state, so a JAX run resumes in the port.
Nothing here imports jax: JAX values are read as NumPy arrays through
attribute access, and the reverse direction returns NumPy fields to build
the JAX values from.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mot_torch.models.yolo import YoloSpec, layer_shapes
from tpu_mot_torch.ops.kcf import KCFModel
from tpu_mot_torch.tracker.bank import TrackBank
from tpu_mot_torch.tracker.kcf_bank import KCFBank

_FIELDS = TrackBank._fields


def cf_to_complex(re, im, device=None) -> torch.Tensor:
    """A split-complex pair (array-likes) -> complex64 tensor."""
    return torch.complex(torch.as_tensor(np.array(re, np.float32)),
                         torch.as_tensor(np.array(im, np.float32))
                         ).to(device)


def complex_to_cf(z: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """complex64 tensor -> (re, im) float32 NumPy arrays."""
    z = z.detach().cpu()
    return (z.real.numpy().astype(np.float32),
            z.imag.numpy().astype(np.float32))


def _model_from_jax(jmodel, device=None) -> KCFModel:
    return KCFModel(
        xf=cf_to_complex(jmodel.xf.re, jmodel.xf.im, device),
        alphaf=cf_to_complex(jmodel.alphaf.re, jmodel.alphaf.im, device))


def _model_to_numpy(model: KCFModel) -> dict:
    return {"xf": complex_to_cf(model.xf),
            "alphaf": complex_to_cf(model.alphaf)}


def bank_from_jax(jbank, device=None) -> TrackBank:
    """A tpu_mot TrackBank (JAX or NumPy leaves) -> the port's TrackBank;
    a stacked stream bank (tpu_mot.parallel.serve.make_stream_banks, every
    leaf with a leading [S]) gives the port's stacked bank."""
    fields = {}
    for name in _FIELDS:
        if name == "kcf":
            fields[name] = _model_from_jax(jbank.kcf, device)
        else:
            fields[name] = torch.as_tensor(
                np.array(getattr(jbank, name)), device=device)
    return TrackBank(**fields)


def bank_to_numpy(bank: TrackBank) -> dict:
    """The port's TrackBank (or stacked stream bank) -> {field: NumPy
    array} with the JAX field names; "kcf" maps to {"xf": (re, im),
    "alphaf": (re, im)}, ready to wrap in tpu_mot's CF / KCFModel /
    TrackBank."""
    out = {}
    for name in _FIELDS:
        v = getattr(bank, name)
        if name == "kcf":
            out[name] = _model_to_numpy(v)
        else:
            out[name] = v.detach().cpu().numpy()
    return out


def kcf_bank_from_jax(jbank, device=None) -> KCFBank:
    """A tpu_mot.tracker.kcf_bank.KCFBank (JAX or NumPy leaves) -> the
    port's KCFBank."""
    return KCFBank(
        model=_model_from_jax(jbank.model, device),
        boxes=torch.as_tensor(np.array(jbank.boxes), device=device),
        alive=torch.as_tensor(np.array(jbank.alive), device=device))


def kcf_bank_to_numpy(bank: KCFBank) -> dict:
    """The port's KCFBank -> {"model": {"xf": (re, im), "alphaf": (re, im)},
    "boxes", "alive"} of NumPy arrays."""
    return {"model": _model_to_numpy(bank.model),
            "boxes": bank.boxes.detach().cpu().numpy(),
            "alive": bank.alive.detach().cpu().numpy()}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _param_leaves(params) -> dict:
    """A flax params tree {name: {"conv": {"kernel" HWIO[, "bias"]}[, "bn":
    {"scale", "bias"}]}} (or an optimizer moment of the same shape) ->
    {state-dict name: float32 tensor}, kernels OIHW."""
    sd = {}
    for name, p in params.items():
        conv = p["conv"]
        sd[f"{name}.conv.weight"] = _t(np.transpose(np.asarray(conv["kernel"]),
                                                    (3, 2, 0, 1)))
        if "bias" in conv:
            sd[f"{name}.conv.bias"] = _t(conv["bias"])
        if "bn" in p:
            sd[f"{name}.bn.weight"] = _t(p["bn"]["scale"])
            sd[f"{name}.bn.bias"] = _t(p["bn"]["bias"])
    return sd


def yolo_params_from_jax(tree) -> dict:
    """A flax YOLO variable tree {"params": {name: {"conv": {"kernel"
    HWIO[, "bias"]}[, "bn": {"scale", "bias"}]}}, "batch_stats": {name:
    {"bn": {"mean", "var"}}}} (NumPy or JAX leaves) -> the port's state
    dict (float32 tensors on the CPU; kernels OIHW)."""
    sd = _param_leaves(tree["params"])
    for name, stats in tree["batch_stats"].items():
        sd[f"{name}.bn.running_mean"] = _t(stats["bn"]["mean"])
        sd[f"{name}.bn.running_var"] = _t(stats["bn"]["var"])
        sd[f"{name}.bn.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64)
    return sd


def _adam_of(opt_state):
    """The ScaleByAdamState in an optax state (itself, or nested in the
    tuples a chain builds), else None."""
    if hasattr(opt_state, "mu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for x in opt_state:
            found = _adam_of(x)
            if found is not None:
                return found
    return None


def yolo_train_state_from_jax(params, batch_stats, opt_state):
    """The JAX package's train state (params, batch_stats, opt_state of
    optax.adam: a ScaleByAdamState (count, mu, nu), alone or first in the
    chain's tuple) -> (state dict, Adam state): {parameter name: {"step",
    "exp_avg", "exp_avg_sq"}}, torch.optim.Adam's per-parameter state, the
    moments OIHW.  parallel.train.train_state_from_params(spec,
    make_optimizer, *these) then resumes the JAX run."""
    adam = _adam_of(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no ScaleByAdamState (count, mu, "
                         "nu): only optax.adam's state converts")
    sd = yolo_params_from_jax({"params": params, "batch_stats": batch_stats})
    mu, nu = _param_leaves(adam.mu), _param_leaves(adam.nu)
    step = float(np.asarray(adam.count))
    state = {name: {"step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": mu[name], "exp_avg_sq": nu[name]}
             for name in mu}
    return sd, state


def yolo_params_to_jax(state_dict) -> dict:
    """The port's YOLO state dict -> the flax variable tree of NumPy
    float32 arrays (the inverse of yolo_params_from_jax)."""
    params, stats = {}, {}
    for key, v in state_dict.items():
        name, part, field = key.split(".")
        if field == "num_batches_tracked":
            continue
        a = v.detach().cpu().numpy().astype(np.float32)
        if part == "conv":
            conv = params.setdefault(name, {}).setdefault("conv", {})
            if field == "weight":
                conv["kernel"] = np.ascontiguousarray(
                    np.transpose(a, (2, 3, 1, 0)))
            else:
                conv["bias"] = a
        elif field in ("weight", "bias"):
            params.setdefault(name, {}).setdefault("bn", {})[
                "scale" if field == "weight" else "bias"] = a
        else:
            stats.setdefault(name, {}).setdefault("bn", {})[
                "mean" if field == "running_mean" else "var"] = a
    return {"params": params, "batch_stats": stats}


def numpy_yolo_params(spec: YoloSpec, seed: int = 0) -> dict:
    """A flax-layout YOLO variable tree drawn from
    np.random.default_rng(seed), layer by layer in construction order:
    kernels N(0, 1/fan_in) (lecun-normal's scale, not its draw), BatchNorm
    scale U(0.5, 1.5), bias N(0, 0.1), mean N(0, 0.1), var U(0.5, 1.5)
    (not the identity, so that a swapped field shows), head biases
    N(0, 0.1).  The same seed gives the same weights in both packages and
    on any device."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, (kh, kw, ci, co), has_bn in layer_shapes(spec):
        kernel = (rng.standard_normal((kh, kw, ci, co))
                  / np.sqrt(kh * kw * ci)).astype(np.float32)
        params[name] = {"conv": {"kernel": kernel}}
        if has_bn:
            params[name]["bn"] = {
                "scale": rng.uniform(0.5, 1.5, co).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(co)).astype(np.float32)}
            stats[name] = {"bn": {
                "mean": (0.1 * rng.standard_normal(co)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, co).astype(np.float32)}}
        else:
            params[name]["conv"]["bias"] = (
                0.1 * rng.standard_normal(co)).astype(np.float32)
    return {"params": params, "batch_stats": stats}
