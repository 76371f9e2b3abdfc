"""The port's public surface against the JAX package's, on the CPU:

  (a) `tpu_mot_torch` exports `tpu_mot`'s eight names, each the port
      module's own object, loaded on first access (importing the package
      imports none of its modules);
  (b) TrackBank.alive, .confirmed and .boxes equal JAX's on a bank carried
      over by interop;
  (c) parallel/dryrun.entry, the counterpart of __graft_entry__.entry:
      the same inputs, and one step of its fn equal to JAX's (ids, valid
      and lifecycle exact, boxes atol 1e-3 as tests/test_torch_tracker.py).
"""

import importlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import tpu_mot
import tpu_mot_torch
from tpu_mot_torch import interop
from tpu_mot_torch.parallel import dryrun

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(tpu_mot._EXPORTS))
def test_export_is_the_modules_own_object(name):
    module, attr = tpu_mot_torch._EXPORTS[name]
    assert module == tpu_mot._EXPORTS[name][0].replace("tpu_mot",
                                                       "tpu_mot_torch", 1)
    assert attr == tpu_mot._EXPORTS[name][1]
    assert getattr(tpu_mot_torch, name) is getattr(
        importlib.import_module(module), attr)
    assert name in tpu_mot_torch.__all__


def test_exports_are_lazy_and_unknown_names_raise():
    assert set(tpu_mot_torch._EXPORTS) == set(tpu_mot._EXPORTS)
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        tpu_mot_torch.nope
    code = textwrap.dedent("""
        import sys
        import tpu_mot_torch
        assert not [m for m in sys.modules
                    if m.startswith("tpu_mot_torch.")], sorted(sys.modules)
        tpu_mot_torch.MultiTracker
        assert "tpu_mot_torch.tracker.api" in sys.modules
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _jax_steps(n):
    """n steps of __graft_entry__.entry's fn from its inputs: (bank,
    output) after each."""
    fn, (bank, frame, dets, valid) = __graft_entry__.entry()
    step = jax.jit(fn)
    seen = []
    for _ in range(n):
        bank, out = step(bank, frame, dets, valid)
        seen.append((bank, out))
    return seen


def test_bank_properties_match_jax():
    for jbank, _ in _jax_steps(3):
        bank = interop.bank_from_jax(jbank, device="cpu")
        for prop in ("alive", "confirmed", "boxes"):
            np.testing.assert_array_equal(getattr(bank, prop).numpy(),
                                          np.asarray(getattr(jbank, prop)),
                                          err_msg=prop)
    # both values of each mask were compared
    assert bank.confirmed.any() and not bank.alive.all()


def test_entry_matches_the_jax_entry():
    _, jargs = __graft_entry__.entry()
    fn, args = dryrun.entry(device="cpu")
    assert all(x.device.type == "cpu" for x in args[1:])
    for got, want in zip(args[1:], jargs[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jbank, jout = _jax_steps(1)[0]
    bank, out = fn(*args)
    for k in ("ids", "valid", "matched_det", "cls", "n_alive", "n_births"):
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(jout, k)),
                                      err_msg=k)
    np.testing.assert_allclose(out.boxes.numpy(), np.asarray(jout.boxes),
                               rtol=0, atol=1e-3)
    for k in ("ids", "state", "hits"):
        np.testing.assert_array_equal(getattr(bank, k).numpy(),
                                      np.asarray(getattr(jbank, k)),
                                      err_msg=k)
    assert int(out.n_births) == 8


def test_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun.entry()
