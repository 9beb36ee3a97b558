"""Checkpoint / resume: model weights and mid-sequence pipeline state (torch).

Counterpart of ``boxfusion_tpu/utils/checkpoint.py``, which writes orbax
checkpoint directories.  Orbax is a JAX library, so this package has its own
format: ONE file per snapshot, written by ``torch.save`` and read back with
``weights_only=True`` (tensors and plain containers only -- a snapshot never
runs code when it is loaded).

  * model weights save/restore as a ``state_dict``;
  * the *entire device-resident pipeline state* (world set + manager +
    observation bank, runtime/device_state.py) snapshots and resumes
    mid-sequence as a ``{field: CPU tensor}`` tree.

The two packages' files do not read each other.  A state crosses between them
as a ``{field: ndarray}`` tree: ``runtime/device_state.py:state_to_numpy`` /
``state_from_numpy`` on this side.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import torch

from boxfusion_tpu_torch.utils.device import DeviceLike


def _save(path: str, tree: Mapping[str, torch.Tensor]) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in tree.items()}, tmp)
    os.replace(tmp, path)  # a reader never sees half a file


def _load(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """Save a module's ``state_dict`` (or any flat name -> tensor mapping)."""
    _save(path, params)


def restore_params(path: str, template: torch.nn.Module = None):
    """The saved ``state_dict``; with ``template`` (a module) the weights are
    loaded into it, strictly, and the module is returned."""
    params = _load(path)
    if template is None:
        return params
    template.load_state_dict(params, strict=True)
    return template


def save_pipeline_state(path: str, state) -> None:
    """Snapshot a DeviceState mid-sequence (all tensors + counters)."""
    from boxfusion_tpu_torch.runtime.device_state import FIELD_NAMES, DeviceState

    assert isinstance(state, DeviceState)
    _save(path, {name: getattr(state, name) for name in FIELD_NAMES})


def restore_pipeline_state(path: str, device: DeviceLike = None):
    """The snapshot as a DeviceState on ``device`` (default "cuda").

    Stats counters were added (and later widened) over time; a snapshot with
    absent or narrower ``stats`` restores zero-padded to the current width,
    so the restored state matches ``init_state``'s shapes exactly."""
    from boxfusion_tpu_torch.runtime.device_state import state_from_numpy

    return state_from_numpy({k: v.numpy() for k, v in _load(path).items()}, device)
