"""Checkpoint / resume (counterpart of tpu_mot/utils/checkpoint.py): any
tree of dicts, lists, tuples, NamedTuples and tensors, and the whole
pipeline's state (tracker bank, detector weights, config) in one call.

  * A path ending in .npz is a flat np.savez whose keys are the JAX
    package's (jax.tree_util.keystr of the same tree: "['bank'].boxes",
    "['bank'].kcf.xf.re"; dict keys sorted).  A complex64 tensor is saved
    as its split-complex pair, the ".re" and ".im" of the JAX package's
    CF, so a TrackBank snapshot written by either package loads into the
    other.
  * Any other path is a directory holding `state.pt` (torch.save of the
    tree with its tensors on the CPU).  A `state.pkl` there (the JAX
    package's pickle form) still loads.  An orbax directory, the JAX
    package's default, is JAX-only: loading one raises.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, prefix: str = ""):
    """(keystr, leaf) pairs of a tree in jax.tree_util's order and
    notation; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rebuild(like, leaf_fn, prefix: str = ""):
    """A tree with the structure of `like` whose leaf at keystr k is
    leaf_fn(k, the leaf of like)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf_fn, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaf_fn,
                                     f"{prefix}.{f}") for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaf_fn, f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    return leaf_fn(prefix, like)


def _to_cpu(tree):
    return _rebuild(tree, lambda _, x: (x.detach().cpu()
                                        if isinstance(x, torch.Tensor)
                                        else x))


def _device_of(like) -> torch.device:
    for _, leaf in _walk(like):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def save_pytree(path: str, tree) -> None:
    """Persist a tree: a .npz path -> flat npz with the JAX package's keys;
    any other path -> the directory path/ with state.pt."""
    if path.endswith(".npz"):
        flat = {}
        for key, leaf in _walk(tree):
            a = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                 else np.asarray(leaf))
            if np.iscomplexobj(a):
                flat[key + ".re"] = np.ascontiguousarray(a.real)
                flat[key + ".im"] = np.ascontiguousarray(a.imag)
            else:
                flat[key] = a
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **flat)
        return
    os.makedirs(path, exist_ok=True)
    torch.save(_to_cpu(tree), os.path.join(path, "state.pt"))


def load_pytree(path: str, like=None):
    """Restore a tree.

    .npz: `like` gives the structure, the dtypes (a complex leaf reads its
    ".re"/".im" pair) and the device (each leaf's).  A directory: the tree
    as saved, its tensors on the device of like's first tensor (the CPU
    without like).  Only files this program or the JAX package wrote
    should be loaded: both forms unpickle."""
    if path.endswith(".npz"):
        if like is None:
            raise ValueError("loading a .npz needs `like` for the structure")
        with np.load(path) as data:
            def leaf(key, ref):
                if isinstance(ref, torch.Tensor) and ref.is_complex():
                    a = data[key + ".re"] + 1j * data[key + ".im"]
                    return torch.as_tensor(a.astype(np.complex64),
                                           device=ref.device)
                if isinstance(ref, torch.Tensor):
                    return torch.as_tensor(data[key], device=ref.device)
                return data[key]
            return _rebuild(like, leaf)
    device = _device_of(like)
    pt = os.path.join(path, "state.pt")
    pkl = os.path.join(path, "state.pkl")
    if os.path.isfile(pt):
        return torch.load(pt, map_location=device, weights_only=False)
    if os.path.isdir(path) and not os.path.isfile(pkl):
        if any(os.path.exists(os.path.join(path, m))
               for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an orbax checkpoint: orbax directories are "
                "JAX-only; re-save the tree from the JAX package as a .npz "
                "(tpu_mot.utils.checkpoint.save_pytree(path + '.npz', "
                "tree)) and load that")
        raise FileNotFoundError(f"{path} holds no state.pt or state.pkl")
    with open(pkl if os.path.isdir(path) else path, "rb") as f:
        tree = pickle.load(f)
    return _rebuild(tree, lambda _, x: (torch.as_tensor(np.asarray(x),
                                                        device=device)
                                        if isinstance(x, np.ndarray) else x))


def save_pipeline(path: str, bank, detector_params=None, cfg=None) -> None:
    """One-call snapshot of the serving state (mid-video resume): the tree
    {"bank": bank, "detector": detector_params} into path/state (a
    directory) or path itself (.npz), and cfg pickled beside it
    (path/config.pkl, or <path>_config.pkl for a .npz)."""
    tree = {"bank": bank}
    if detector_params is not None:
        tree["detector"] = detector_params
    npz = path.endswith(".npz")
    save_pytree(path if npz else os.path.join(path, "state"), tree)
    if cfg is not None:
        cfg_path = (path[:-len(".npz")] + "_config.pkl" if npz
                    else os.path.join(path, "config.pkl"))
        os.makedirs(os.path.dirname(cfg_path) or ".", exist_ok=True)
        with open(cfg_path, "wb") as f:
            pickle.dump(cfg, f)


def load_pipeline(path: str, like_bank, detector_like=None):
    """What save_pipeline wrote -> (bank, detector params or None, cfg or
    None); like_bank (e.g. tracker.bank.empty_bank of the config) gives the
    bank's structure and device, detector_like the detector's for a .npz."""
    npz = path.endswith(".npz")
    like = {"bank": like_bank}
    if detector_like is not None:
        like["detector"] = detector_like
    tree = load_pytree(path if npz else os.path.join(path, "state"), like)
    cfg_path = (path[:-len(".npz")] + "_config.pkl" if npz
                else os.path.join(path, "config.pkl"))
    cfg = None
    if os.path.isfile(cfg_path):
        with open(cfg_path, "rb") as f:
            cfg = pickle.load(f)
    return tree["bank"], tree.get("detector"), cfg
