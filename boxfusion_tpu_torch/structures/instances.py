"""Instances: an immutable, fixed-schema instance container (PyTorch).

Port of ``boxfusion_tpu/structures/instances.py``.  Capability target: the
reference's ``Instances3D`` (reference boxfusion/instances.py:128-331) -- a
Detectron2-style bag of equal-length fields with ``set/get/has``, indexing,
``cat``, ``clone`` and ``split``.

As in the JAX package, this is an immutable mapping: indexing, ``cat``,
``set`` and masking return new objects.  Fields are torch tensors, numpy
arrays or lists.  The JAX class is a registered pytree so that it moves
through ``jit``; here ``.to(device)`` moves every tensor field instead.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Union

import numpy as np
import torch

IndexLike = Union[int, slice, np.ndarray, torch.Tensor, list]


class Instances:
    """Immutable container of equal-length per-instance fields.

    Mirrors the reference API surface (instances.py:128-331):
    ``set`` (returns a new object), ``get``, ``has``, ``remove``,
    ``__getitem__`` (int / slice / bool mask / index array), ``__len__``,
    ``cat``, ``clone``, ``split``; plus ``to``.
    """

    __slots__ = ("_fields",)

    def __init__(self, **fields: Any):
        lengths = {k: _field_len(v) for k, v in fields.items()}
        if lengths:
            n = next(iter(lengths.values()))
            for k, l in lengths.items():
                if l != n:
                    raise ValueError(
                        f"Field '{k}' has length {l}, expected {n}: {lengths}"
                    )
        object.__setattr__(self, "_fields", dict(fields))

    # -- basic protocol ----------------------------------------------------
    def __len__(self) -> int:
        for v in self._fields.values():
            return _field_len(v)
        return 0

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __getattr__(self, name: str) -> Any:
        if name == "_fields":
            raise AttributeError(name)
        try:
            return self._fields[name]
        except KeyError:
            raise AttributeError(f"No field '{name}' in Instances") from None

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("Instances is immutable; use .set(name, value)")

    def get(self, name: str) -> Any:
        return self._fields[name]

    def has(self, name: str) -> bool:
        return name in self._fields

    def set(self, name: str, value: Any) -> "Instances":
        if self._fields and _field_len(value) != len(self):
            raise ValueError(
                f"Adding field '{name}' of length {_field_len(value)} to "
                f"Instances of length {len(self)}"
            )
        new = dict(self._fields)
        new[name] = value
        return Instances(**new)

    def remove(self, name: str) -> "Instances":
        new = dict(self._fields)
        del new[name]
        return Instances(**new)

    def get_fields(self) -> Dict[str, Any]:
        return dict(self._fields)

    def to(self, device) -> "Instances":
        """Every tensor field on ``device``; other fields as they are."""
        return Instances(**{k: v.to(device) if isinstance(v, torch.Tensor) else v
                            for k, v in self._fields.items()})

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, item: IndexLike) -> "Instances":
        if isinstance(item, int):
            if item >= len(self) or item < -len(self):
                raise IndexError("Instances index out of range")
            item = slice(item, item + 1 if item != -1 else None)

        new = {}
        for k, v in self._fields.items():
            if isinstance(v, torch.Tensor):
                idx = item
                if isinstance(idx, (np.ndarray, list)):
                    idx = torch.as_tensor(np.asarray(idx), device=v.device)
                elif isinstance(idx, torch.Tensor):
                    idx = idx.to(v.device)
                new[k] = v[idx]
            elif isinstance(v, np.ndarray):
                idx = item.cpu().numpy() if isinstance(item, torch.Tensor) else item
                new[k] = v[idx]
            elif isinstance(v, (list, tuple)):
                new[k] = _index_sequence(v, item)
            else:
                raise TypeError(f"Cannot index field '{k}' of type {type(v)}")
        return Instances(**new)

    def split(self, sizes_or_n) -> List["Instances"]:
        idx = np.arange(len(self))
        parts = np.array_split(idx, sizes_or_n) if isinstance(sizes_or_n, int) else [
            idx[s : s + n] for s, n in zip(np.cumsum([0] + list(sizes_or_n))[:-1], sizes_or_n)
        ]
        return [self[p] for p in parts]

    def clone(self) -> "Instances":
        new = {}
        for k, v in self._fields.items():
            if isinstance(v, torch.Tensor):
                new[k] = v.clone()
            elif isinstance(v, np.ndarray):
                new[k] = np.copy(v)
            elif isinstance(v, (list, tuple)):
                new[k] = type(v)(v)
            else:
                new[k] = v
        return Instances(**new)

    @staticmethod
    def cat(instance_lists: Iterable["Instances"]) -> "Instances":
        instance_lists = list(instance_lists)
        if not instance_lists:
            raise ValueError("Instances.cat of an empty list")
        if len(instance_lists) == 1:
            return instance_lists[0]
        keys = instance_lists[0]._fields.keys()
        out = {}
        for k in keys:
            vals = [i.get(k) for i in instance_lists]
            v0 = vals[0]
            if isinstance(v0, torch.Tensor):
                out[k] = torch.cat(vals, dim=0)
            elif isinstance(v0, np.ndarray):
                out[k] = np.concatenate(vals, axis=0)
            elif isinstance(v0, list):
                out[k] = [x for v in vals for x in v]
            else:
                raise TypeError(f"Cannot cat field '{k}' of type {type(v0)}")
        return Instances(**out)

    def __repr__(self) -> str:
        f = ", ".join(f"{k}: {_describe(v)}" for k, v in self._fields.items())
        return f"Instances(num={len(self)}, fields=[{f}])"


def _field_len(v: Any) -> int:
    return int(v.shape[0]) if hasattr(v, "shape") else len(v)


def _index_sequence(v, item):
    if isinstance(item, slice):
        return v[item]
    arr = item.cpu().numpy() if isinstance(item, torch.Tensor) else np.asarray(item)
    if arr.dtype == np.bool_:
        return [x for x, m in zip(v, arr) if m]
    return [v[int(i)] for i in arr]


def _describe(v: Any) -> str:
    if hasattr(v, "shape"):
        return f"{type(v).__name__}{tuple(v.shape)}"
    return f"{type(v).__name__}[{len(v)}]"
