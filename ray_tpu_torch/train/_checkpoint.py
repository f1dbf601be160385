"""Checkpoint: the portable training-state handle.

Reference: ``ray.air.Checkpoint`` / ``ray.train.Checkpoint`` — dir / dict
/ URI forms, convertible.  ``save_pytree`` / ``restore_pytree`` write and
read a nested dict (lists, tuples) of tensors with ``torch.save``, every
tensor on the CPU in the file; a restore maps them to the device named, or
to the template's, and never to a CUDA device unasked (a checkpoint a GPU
worker wrote must load in a driver that sees other cards, or none).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Dict, Iterator, Optional


class Checkpoint:
    """Immutable handle to checkpoint data (a directory or a dict)."""

    def __init__(self, path: Optional[str] = None,
                 _data: Optional[Dict[str, Any]] = None):
        if (path is None) == (_data is None):
            raise ValueError("exactly one of path/_data")
        self._path = path
        self._data = _data

    # -------------------------------------------------------- constructors
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=os.path.abspath(path))

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(_data=dict(data))

    # ---------------------------------------------------------- accessors
    @property
    def path(self) -> Optional[str]:
        return self._path

    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        blob = os.path.join(self._path, "_dict_checkpoint.pkl")
        if os.path.exists(blob):
            with open(blob, "rb") as f:
                return pickle.load(f)
        raise ValueError(
            f"directory checkpoint {self._path} has no dict payload")

    def to_directory(self, path: Optional[str] = None) -> str:
        out = path or tempfile.mkdtemp(prefix="rtt_ckpt_")
        os.makedirs(out, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(out) != os.path.abspath(self._path):
                shutil.copytree(self._path, out, dirs_exist_ok=True)
        else:
            with open(os.path.join(out, "_dict_checkpoint.pkl"), "wb") as f:
                pickle.dump(self._data, f, protocol=5)
        return out

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        if self._path is not None:
            yield self._path
        else:
            out = self.to_directory()
            try:
                yield out
            finally:
                shutil.rmtree(out, ignore_errors=True)

    def __repr__(self) -> str:
        src = self._path if self._path is not None else "<dict>"
        return f"Checkpoint({src})"


# ------------------------------------------------------------- tensor trees
PYTREE_FILE = "pytree.pt"


def _map_tree(fn: Callable[[Any, Any], Any], tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over every tensor of ``tree``, walking
    ``other`` (the template, or None) in step; dicts, lists and tuples
    are rebuilt, any other leaf is kept as it is."""
    if isinstance(tree, dict):
        if other is not None and set(tree) != set(other):
            raise ValueError(f"checkpoint keys {sorted(tree)} differ from "
                             f"the template's {sorted(other)}")
        return {k: _map_tree(fn, v, None if other is None else other[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if other is not None and len(tree) != len(other):
            raise ValueError(f"checkpoint sequence of {len(tree)} differs "
                             f"from the template's {len(other)}")
        return type(tree)(
            _map_tree(fn, v, None if other is None else other[i])
            for i, v in enumerate(tree))
    import torch
    if isinstance(tree, torch.Tensor):
        return fn(tree, other)
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors) into the
    directory ``path`` with ``torch.save``, every tensor copied to the CPU
    first.  An existing directory is replaced."""
    import torch
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    host = _map_tree(lambda t, _: t.detach().to("cpu", copy=True), tree,
                     None)
    torch.save(host, os.path.join(path, PYTREE_FILE))


def restore_pytree(path: str, template: Optional[Any] = None,
                   device: Optional[Any] = None) -> Any:
    """Read the tree ``save_pytree`` wrote.  Tensors land on ``device``
    when it is given, else on the template's leaf's device (the template
    must have the checkpoint's structure, shapes and dtypes), else on the
    CPU."""
    import torch
    tree = torch.load(os.path.join(os.path.abspath(path), PYTREE_FILE),
                      map_location="cpu", weights_only=True)

    def place(t, ref):
        if ref is not None and (t.shape != ref.shape or t.dtype != ref.dtype):
            raise ValueError(f"checkpoint tensor {tuple(t.shape)} {t.dtype} "
                             f"differs from the template's "
                             f"{tuple(ref.shape)} {ref.dtype}")
        dev = device if device is not None else \
            (ref.device if ref is not None else None)
        return t if dev is None else t.to(dev)

    return _map_tree(place, tree, template)
