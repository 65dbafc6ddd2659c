"""Checkpoint: a handle to a directory of model state.

Counterpart of ``ray_tpu/train/checkpoint.py``. A ``Checkpoint`` is a path;
``from_directory`` / ``to_directory`` / ``as_directory`` move it between
local disk and storage. In place of ``save_pytree`` / ``restore_pytree`` the
port has ``save_state_dict`` / ``restore_state_dict`` over nested dicts of
tensors, in the same two files, so a checkpoint crosses between the
packages:

- ``_pytree_leaves.npz``: one array per leaf, ``leaf_i``, in JAX's flatten
  order (nested dicts by sorted key). bfloat16, which ``np.savez`` keeps no
  type for, is stored as its 16 bits viewed as void ``V2``, as a JAX-written
  bf16 leaf reads back from ``np.load``; the manifest says ``"bfloat16"``.
- ``_pytree_manifest.json``: ``n_leaves`` and each leaf's dtype and shape.
  JAX's ``treedef`` is a cloudpickled ``PyTreeDef`` that only JAX can read,
  so the port writes ``"treedef": null`` and adds ``"keys"``, the leaves'
  dotted names in flatten order. A JAX-written checkpoint has no keys: the
  port reads it into a template (``like``) whose flattened keys name the
  leaves. JAX's ``restore_pytree`` cannot read a port checkpoint (no
  treedef); its leaves still rebuild a JAX tree in order.

Non-tensor leaves (a train state's step) are stored as 0-d arrays. Leaves
are written and read one at a time, so a host holds one leaf's bytes, not
the whole state.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import zipfile
from contextlib import contextmanager
from typing import Any, Optional, Union

import numpy as np
import torch

_PYTREE_MANIFEST = "_pytree_manifest.json"
_PYTREE_DATA = "_pytree_leaves.npz"
_DICT = "_dict.pkl"


class Checkpoint:
    """A directory of serialized state, addressable by path.

    The reference's surface (``train/_checkpoint.py``):
    ``Checkpoint.from_directory(path)``, ``chk.to_directory(dst)``,
    ``with chk.as_directory() as d:``, plus dict and state-dict helpers."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        # set on checkpoints created in framework-owned tempdirs
        # (from_dict/from_state_dict): report() moves or deletes the source
        # after persisting it, so per-step checkpoints don't pile up in /tmp
        self._ephemeral = False

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Checkpoint":
        """Small states for tests: a pickled dict in a tempdir (the standard
        pickle; the JAX package's cloudpickle reads it too)."""
        d = tempfile.mkdtemp(prefix="rtpu-chk-")
        with open(os.path.join(d, _DICT), "wb") as f:
            pickle.dump(data, f)
        chk = cls(d)
        chk._ephemeral = True
        return chk

    @classmethod
    def from_state_dict(cls, tree: dict, path: Optional[str] = None) -> "Checkpoint":
        d = path or tempfile.mkdtemp(prefix="rtpu-chk-")
        os.makedirs(d, exist_ok=True)
        save_state_dict(tree, d)
        chk = cls(d)
        chk._ephemeral = path is None
        return chk

    # -- accessors ----------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        with open(os.path.join(self.path, _DICT), "rb") as f:
            return pickle.load(f)

    def to_state_dict(self, like: Optional[dict] = None,
                      device: Union[str, torch.device] = "cpu") -> dict:
        return restore_state_dict(self.path, like=like, device=device)

    def to_directory(self, dst: Optional[str] = None) -> str:
        dst = dst or tempfile.mkdtemp(prefix="rtpu-chk-")
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(self.path, dst, dirs_exist_ok=True)
        return dst

    @contextmanager
    def as_directory(self):
        """Local checkpoints are yielded in place (zero-copy)."""
        yield self.path

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


# -- flattening, in JAX's order ----------------------------------------------

_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, bool, int, float)


def flatten_state_dict(tree: dict, prefix: str = "") -> list[tuple[str, Any]]:
    """(dotted key, leaf) pairs in ``jax.tree_util.tree_flatten``'s order
    for nested dicts: keys sorted at every level, None dropped (JAX's empty
    subtree). Keys are strings without dots."""
    out = []
    for k in sorted(tree):
        if not isinstance(k, str) or "." in k:
            raise ValueError(f"state dict keys must be strings without '.': {prefix}{k!r}")
        v = tree[k]
        if v is None:
            continue
        if isinstance(v, dict):
            out += flatten_state_dict(v, f"{prefix}{k}.")
        elif isinstance(v, _LEAF_TYPES):
            out.append((prefix + k, v))
        else:
            raise TypeError(f"{prefix}{k}: cannot store a {type(v).__name__} in a state dict")
    return out


def unflatten_state_dict(pairs) -> dict:
    tree: dict = {}
    for key, leaf in pairs:
        *parents, last = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _dtype_name(dtype) -> str:
    """Manifest dtype name: numpy's, with "bfloat16" for torch's and
    ml_dtypes' bf16."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name."""
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _to_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the host array to store and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    arr = np.asarray(leaf)  # write_array writes any layout in C order
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16
        return arr.view(np.int16).view("V2"), "bfloat16"
    return arr, arr.dtype.name


def _from_array(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# -- state dict <-> directory ------------------------------------------------


def save_state_dict(tree: dict, directory: str) -> None:
    """Persist a nested dict of tensors (numpy arrays, Python numbers) in
    the JAX package's format, leaf by leaf: a CUDA leaf is copied to the
    host, written, and its host copy dropped before the next."""
    pairs = flatten_state_dict(tree)
    meta = []
    # np.savez's own layout (stored zip members named leaf_i.npy), written
    # one member at a time
    with zipfile.ZipFile(os.path.join(directory, _PYTREE_DATA), "w",
                         compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (_, leaf) in enumerate(pairs):
            arr, dtype = _to_array(leaf)
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            meta.append({"index": i, "dtype": dtype, "shape": list(arr.shape)})
            del arr
    with open(os.path.join(directory, _PYTREE_MANIFEST), "w") as f:
        json.dump({"n_leaves": len(pairs), "leaves": meta, "treedef": None,
                   "keys": [k for k, _ in pairs]}, f)


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, _PYTREE_MANIFEST)) as f:
        return json.load(f)


def _check_leaf(key: str, tmpl, meta: dict) -> None:
    """The template's leaf against the manifest's dtype and shape."""
    shape = list(getattr(tmpl, "shape", ()))
    if isinstance(tmpl, (torch.Tensor, np.ndarray, np.generic)):
        ok = _dtype_name(tmpl.dtype) == meta["dtype"]
        want = _dtype_name(tmpl.dtype)
    else:  # a Python number: a 0-d leaf of any dtype of its kind
        kind = "f" if meta["dtype"] == "bfloat16" else np.dtype(meta["dtype"]).kind
        want = type(tmpl).__name__
        ok = kind in {bool: "b", int: "iu", float: "f"}[type(tmpl)]
    if not ok or shape != list(meta["shape"]):
        raise ValueError(
            f"checkpoint leaf {key!r} is {meta['dtype']}{meta['shape']}, "
            f"the template wants {want}{shape}"
        )


def restore_state_dict(directory: str, like: Optional[dict] = None,
                       device: Union[str, torch.device] = "cpu") -> dict:
    """Read a checkpoint written by ``save_state_dict`` or by the JAX
    package's ``save_pytree`` into a nested dict of tensors on ``device``.

    ``like`` is a template: a nested dict whose flattened keys name the
    leaves and whose leaves (tensors, meta tensors included, so building
    it allocates nothing; or Python numbers) give each leaf's dtype and
    shape. Every leaf is checked against the manifest before any data is
    read, and a mismatch raises naming the key. A leaf whose template is a
    Python number comes back as one. Without ``like`` the checkpoint must
    carry ``"keys"`` (the port's own); a JAX-written one needs a template.
    Leaves reach ``device`` one at a time."""
    manifest = read_manifest(directory)
    metas = manifest["leaves"]
    keys = manifest.get("keys")
    if like is None:
        if keys is None:
            raise ValueError(
                f"{directory}: the checkpoint names no keys (written by the JAX package); "
                "pass a template `like` whose flattened keys name its leaves"
            )
        plan = [(k, i, None) for i, k in enumerate(keys)]
    else:
        want = flatten_state_dict(like)
        if len(want) != manifest["n_leaves"]:
            raise ValueError(
                f"{directory}: the checkpoint has {manifest['n_leaves']} leaves, "
                f"the template {len(want)}"
            )
        if keys is None:  # JAX's flatten order is the template's
            plan = [(k, i, t) for i, (k, t) in enumerate(want)]
        else:
            index = {k: i for i, k in enumerate(keys)}
            missing = [k for k, _ in want if k not in index]
            if missing:
                raise ValueError(f"{directory}: the checkpoint has no leaf {missing[0]!r}")
            plan = [(k, index[k], t) for k, t in want]
        for key, i, tmpl in plan:
            _check_leaf(key, tmpl, metas[i])
    out = []
    with np.load(os.path.join(directory, _PYTREE_DATA)) as data:
        for key, i, tmpl in plan:
            arr = data[f"leaf_{i}"]
            if list(arr.shape) != list(metas[i]["shape"]):
                raise ValueError(f"checkpoint leaf {key!r}: stored shape {list(arr.shape)} "
                                 f"!= manifest {metas[i]['shape']}")
            t = _from_array(arr, metas[i]["dtype"])
            out.append((key, t.item() if isinstance(tmpl, (bool, int, float)) else t.to(device)))
            del arr, t
    return unflatten_state_dict(out)
