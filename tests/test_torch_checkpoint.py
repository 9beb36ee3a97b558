"""Snapshots of the port: pipeline state and model weights, one file each.

The JAX package snapshots through orbax; the port writes one ``torch.save``
file and reads it with ``weights_only=True`` (utils/checkpoint.py).  The two
formats do not read each other; the state itself crosses as a
``{field: ndarray}`` tree, which is held here against the tree the JAX
package builds from its own state (``boxfusion_tpu/utils/checkpoint.py:43``):
the same 22 names, shapes and dtypes, exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from boxfusion_tpu.runtime import device_state as jax_state

from boxfusion_tpu_torch.runtime.device_state import (
    FIELD_NAMES,
    PAD_ID,
    STATS_WIDTH,
    export_world,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from boxfusion_tpu_torch.utils.checkpoint import (
    restore_params,
    restore_pipeline_state,
    save_params,
    save_pipeline_state,
)

torch.set_num_threads(2)


def _jax_tree(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _random_state(seed=0, G=6, V=5, M=12):
    """A state whose every field differs from init_state's."""
    rng = np.random.RandomState(seed)
    tree = state_to_numpy(init_state(G, V, M, device="cpu"))
    for name, a in tree.items():
        if a.dtype == np.float32:
            tree[name] = rng.randn(*a.shape).astype(np.float32)
        elif a.dtype == np.bool_:
            tree[name] = rng.rand(*a.shape) > 0.5
        else:
            tree[name] = rng.randint(0, 7, a.shape).astype(np.int32)
    tree["n"] = np.int32(4)
    return state_from_numpy(tree, device="cpu"), tree


def test_init_state_matches_jax_init_state():
    want = _jax_tree(jax_state.init_state(capacity=6, max_views=5, obs_capacity=12))
    got = state_to_numpy(init_state(6, 5, 12, device="cpu"))
    assert list(got) == list(want) == list(FIELD_NAMES) and len(got) == 22
    assert PAD_ID == int(jax_state.PAD_ID) and STATS_WIDTH == jax_state.STATS_WIDTH
    for name in want:
        assert got[name].shape == want[name].shape and got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_state_crosses_to_jax_and_back():
    """torch state -> tree -> JAX DeviceState -> tree -> torch state: exact,
    and export_world names the same keys and stats on both sides."""
    import jax.numpy as jnp

    state, tree = _random_state()
    jstate = jax_state.DeviceState(**{k: jnp.asarray(v) for k, v in state_to_numpy(state).items()})
    back = state_from_numpy(_jax_tree(jstate), device="cpu")
    for name in FIELD_NAMES:
        a, b = getattr(state, name), getattr(back, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    jw, tw = jax_state.export_world(jstate), export_world(state)
    assert list(jw) == list(tw) and jw["stats"] == tw["stats"]
    assert jw["fusion_list"] == tw["fusion_list"]
    for k in ("xyzlhw", "R", "scores", "category", "init_id", "fusion_flag"):
        np.testing.assert_array_equal(jw[k], tw[k], err_msg=k)


def test_pipeline_state_round_trip(tmp_path):
    state, tree = _random_state(seed=1)
    path = str(tmp_path / "snap" / "state.pt")
    save_pipeline_state(path, state)
    back = restore_pipeline_state(path, device="cpu")
    for name in FIELD_NAMES:
        a, b = getattr(state, name), getattr(back, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # the file holds tensors and plain containers only
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert sorted(raw) == sorted(FIELD_NAMES)


@pytest.mark.parametrize("width", [None, 4])
def test_narrow_or_absent_stats_restore_zero_padded(tmp_path, width):
    """boxfusion_tpu/utils/checkpoint.py:53-59: snapshots from before a
    counter was added restore zero-padded to STATS_WIDTH."""
    state, tree = _random_state(seed=2)
    old = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    if width is None:
        del old["stats"]
    else:
        old["stats"] = old["stats"][:width]
    path = str(tmp_path / "old.pt")
    torch.save(old, path)
    back = restore_pipeline_state(path, device="cpu")
    assert back.stats.shape == (STATS_WIDTH,) and back.stats.dtype == torch.int32
    keep = 0 if width is None else width
    np.testing.assert_array_equal(back.stats[:keep].numpy(), tree["stats"][:keep])
    assert int(back.stats[keep:].abs().sum()) == 0
    assert torch.equal(back.flist, state.flist)


def test_params_round_trip(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3))
    path = str(tmp_path / "w.pt")
    save_params(path, model.state_dict())
    raw = restore_params(path)
    assert sorted(raw) == sorted(model.state_dict())
    fresh = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3))
    assert restore_params(path, fresh) is fresh
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(RuntimeError):
        restore_params(path, torch.nn.Linear(4, 3))
