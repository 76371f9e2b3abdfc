"""Converters between the JAX package's values and the port's.

The JAX package keeps spectra as split-complex CF pairs (re, im) of
float32; the port keeps complex64.  A JAX TrackBank converts to the port's
bank and back field by field, so both packages can start from the same
mid-sequence bank; so does the single-object flow's KCFBank.  Nothing here
imports jax: JAX values are read as NumPy arrays through attribute access,
and the reverse direction returns NumPy fields to build the JAX bank from.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """A tpu_mot TrackBank (JAX or NumPy leaves) -> the port's TrackBank."""
    fields = {}
    for name in _FIELDS:
        if name == "kcf":
            fields[name] = _model_from_jax(jbank.kcf, device)
        else:
            fields[name] = torch.as_tensor(
                np.array(getattr(jbank, name)), device=device)
    return TrackBank(**fields)


def bank_to_numpy(bank: TrackBank) -> dict:
    """The port's TrackBank -> {field: NumPy array} with the JAX field
    names; "kcf" maps to {"xf": (re, im), "alphaf": (re, im)}, ready to
    wrap in tpu_mot's CF / KCFModel / TrackBank."""
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
