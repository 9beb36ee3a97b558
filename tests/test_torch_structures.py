"""The port's structures/ against the JAX package's, on the CPU.

The cases of tests/test_structures.py run on the port (the pytree and jit
case becomes ``.to`` and ``set`` on tensors), then the op-by-op cases of
tests/test_depth_boxes.py hold the port's ``DepthBoxes`` against the JAX
package's class on the same boxes, at 1e-6 (that file holds the JAX class
against the reference, which is not mounted here).  ``GeneralBoxes3D``
and ``Instances`` are held against the JAX classes the same way.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boxfusion_tpu.structures import DepthBoxes as JaxDepthBoxes
from boxfusion_tpu.structures import GeneralBoxes3D as JaxGeneralBoxes3D
from boxfusion_tpu.structures import Instances as JaxInstances

from boxfusion_tpu_torch.structures import DepthBoxes, GeneralBoxes3D, Instances
from boxfusion_tpu_torch.utils.config import load_config

TOL = 1e-6


# ------------------------------------------------------- test_structures.py
def test_instances_basic():
    inst = Instances(scores=torch.tensor([0.9, 0.5, 0.1]), labels=np.array([1, 2, 3]))
    assert len(inst) == 3 and inst.has("scores")
    sub = inst[torch.tensor([True, False, True])]
    assert len(sub) == 2
    np.testing.assert_allclose(sub.scores.numpy(), [0.9, 0.1])
    np.testing.assert_array_equal(sub.labels, [1, 3])
    assert len(Instances.cat([inst, inst])) == 6


def test_instances_immutable_and_to_device():
    inst = Instances(x=torch.arange(4.0), names=["a", "b", "c", "d"])
    with pytest.raises(AttributeError):
        inst.x = torch.zeros(4)
    out = inst.set("y", inst.x + 1)
    np.testing.assert_allclose(out.y.numpy(), [1, 2, 3, 4])
    assert not inst.has("y")
    moved = out.to("cpu")
    assert moved.x.device.type == "cpu" and moved.names == ["a", "b", "c", "d"]
    with pytest.raises(ValueError):
        inst.set("z", torch.zeros(3))


def test_instances_length_mismatch():
    with pytest.raises(ValueError):
        Instances(a=torch.zeros(3), b=torch.zeros(4))


def test_boxes3d_roundtrip():
    b = GeneralBoxes3D(torch.tensor([[1.0, 2.0, 3.0, 2.0, 1.0, 0.5]]), torch.eye(3)[None])
    assert len(b) == 1
    c = b.corners[0].numpy()
    assert c.shape == (8, 3)
    np.testing.assert_allclose(c.mean(axis=0), [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(b.volume.numpy(), [1.0], atol=1e-6)
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([1.0, 0.0, 0.0])
    w = b.transform2world(pose[None])
    np.testing.assert_allclose(w.gravity_center.numpy(), [[2, 2, 3]], atol=1e-6)


def test_config_defaults_and_unknown_keys(tmp_path):
    cfg = load_config("config/ca1m.yaml")
    assert cfg["box_fusion"]["iters"] == 20
    assert cfg["detection"]["class_sim_thres"] == 0.0
    assert cfg["box_fusion"]["clip_sim_coeff"] == 0.0
    bad = tmp_path / "bad.yaml"
    bad.write_text("detection:\n  scor_thresh: 0.2\n")
    with pytest.raises(KeyError):
        load_config(str(bad))


# ------------------------------------------ Instances / GeneralBoxes3D vs JAX
def test_instances_ops_match_jax():
    rng = np.random.RandomState(0)
    s, lbl = rng.rand(9).astype(np.float32), np.arange(9)
    names = [f"n{i}" for i in range(9)]
    port = Instances(scores=torch.from_numpy(s), labels=lbl, names=names)
    ref = JaxInstances(scores=jnp.asarray(s), labels=lbl, names=names)
    mask = rng.rand(9) > 0.5
    for item in (3, -1, slice(2, 7), mask, np.array([8, 0, 4])):
        a, b = port[item], ref[item]
        assert len(a) == len(b)
        np.testing.assert_allclose(a.scores.numpy(), np.asarray(b.scores), atol=0)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.names == b.names
    for pa, pb in zip(port.split([2, 3, 4]), ref.split([2, 3, 4])):
        np.testing.assert_array_equal(pa.scores.numpy(), np.asarray(pb.scores))
    for pa, pb in zip(port.split(4), ref.split(4)):
        assert pa.names == pb.names
    c = port.clone()
    assert c.scores is not port.scores and torch.equal(c.scores, port.scores)
    assert port.remove("names").get_fields().keys() == ref.remove("names").get_fields().keys()
    with pytest.raises(IndexError):
        port[9]


def _rand_general(n=6, seed=0):
    from boxfusion_tpu_torch.geometry.rotation import euler_angles_to_matrix

    rng = np.random.RandomState(seed)
    t = np.concatenate([rng.uniform(-2, 2, (n, 3)), rng.uniform(0.2, 1.5, (n, 3))], 1).astype(np.float32)
    R = euler_angles_to_matrix(torch.from_numpy(rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)),
                               "YXZ").numpy()
    return t, R


def test_general_boxes_match_jax():
    t, R = _rand_general()
    port, ref = GeneralBoxes3D(torch.from_numpy(t), torch.from_numpy(R)), JaxGeneralBoxes3D(jnp.asarray(t),
                                                                                           jnp.asarray(R))
    np.testing.assert_allclose(port.corners.numpy(), np.asarray(ref.corners), atol=TOL)
    np.testing.assert_allclose(port.volume.numpy(), np.asarray(ref.volume), rtol=TOL)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R[0]
    pose[:3, 3] = [0.3, -1.0, 2.0]
    a, b = port.transform2world(torch.from_numpy(pose)), ref.transform2world(jnp.asarray(pose))
    np.testing.assert_allclose(a.tensor.numpy(), np.asarray(b.tensor), atol=TOL)
    np.testing.assert_allclose(a.R.numpy(), np.asarray(b.R), atol=TOL)
    v = np.array([0.1, 0.2, -0.3], np.float32)
    np.testing.assert_allclose(port.translate(torch.from_numpy(v)).tensor.numpy(),
                               np.asarray(ref.translate(jnp.asarray(v)).tensor), atol=TOL)
    both = GeneralBoxes3D.cat(port.split([2, 4]))
    assert torch.equal(both.tensor, port.tensor) and len(port[1]) == 1 and len(port[-1]) == 1
    assert port.to("cpu").R.device.type == "cpu"


# ----------------------------------------------------- test_depth_boxes.py
def _rand_boxes(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(-2, 2, (n, 3)), rng.uniform(0.2, 1.5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)


def _cmp(port: DepthBoxes, ref: JaxDepthBoxes, atol=TOL):
    assert port.with_yaw == ref.with_yaw
    np.testing.assert_allclose(port.tensor.numpy(), np.asarray(ref.tensor), atol=atol, rtol=0)


def test_properties_match():
    t = _rand_boxes()
    port, ref = DepthBoxes(t), JaxDepthBoxes(t)
    for name in ("corners", "gravity_center", "bottom_center", "volume", "top_height", "height",
                 "yaw", "dims", "bottom_height", "center"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=TOL, rtol=0, err_msg=name)
    assert port.shape == ref.shape and len(port) == len(ref)


def test_origin_normalization():
    t = _rand_boxes(seed=1)
    _cmp(DepthBoxes(t, origin=(0.5, 0.5, 0.5)), JaxDepthBoxes(t, origin=(0.5, 0.5, 0.5)))


def test_six_wide_fake_yaw():
    t = _rand_boxes(seed=2)[:, :6]
    port = DepthBoxes(t)
    assert port.with_yaw is False
    _cmp(port, JaxDepthBoxes(t))
    assert DepthBoxes(np.zeros((0, 7), np.float32)).tensor.shape == (0, 7)
    with pytest.raises(ValueError):
        DepthBoxes(np.zeros((3, 5), np.float32))


def test_rotate_scalar_matches():
    t = _rand_boxes(seed=3)
    _cmp(DepthBoxes(t).rotate(0.7), JaxDepthBoxes(t).rotate(0.7))


def test_rotate_matrix_matches():
    t = _rand_boxes(seed=4)
    a = 0.45
    m = np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    _cmp(DepthBoxes(t).rotate(m), JaxDepthBoxes(t).rotate(m))


def test_rotate_no_yaw_aabb_refit():
    t = _rand_boxes(seed=5)[:, :6]
    _cmp(DepthBoxes(t).rotate(0.6), JaxDepthBoxes(t).rotate(0.6))


def test_translate_scale_flip_enlarge():
    t = _rand_boxes(seed=6)
    v = np.array([0.3, -0.2, 0.5], np.float32)
    _cmp(DepthBoxes(t).translate(v), JaxDepthBoxes(t).translate(v))
    _cmp(DepthBoxes(t).scale(1.7), JaxDepthBoxes(t).scale(1.7))
    for d in ("horizontal", "vertical"):
        _cmp(DepthBoxes(t).flip(d), JaxDepthBoxes(t).flip(d))
        _cmp(DepthBoxes(t[:, :6]).flip(d), JaxDepthBoxes(t[:, :6]).flip(d))
    with pytest.raises(ValueError):
        DepthBoxes(t).flip("diagonal")
    _cmp(DepthBoxes(t).enlarged_box(0.12), JaxDepthBoxes(t).enlarged_box(0.12))
    e = np.array([0.1, 0.2, 0.05], np.float32)
    _cmp(DepthBoxes(t).enlarged_box(e), JaxDepthBoxes(t).enlarged_box(e))


def test_predicates_and_container():
    t = _rand_boxes(12, seed=7)
    port, ref = DepthBoxes(t), JaxDepthBoxes(t)
    rng = [-1, -1, -1, 1, 1, 1]
    np.testing.assert_array_equal(port.in_range_3d(rng).numpy(), np.asarray(ref.in_range_3d(rng)))
    np.testing.assert_array_equal(port.nonempty(0.5).numpy(), np.asarray(ref.nonempty(0.5)))
    _cmp(port[3], ref[3])
    _cmp(port[2:7], ref[2:7])
    mask = np.zeros(12, bool)
    mask[[1, 4, 9]] = True
    _cmp(port[mask], ref[mask])
    _cmp(port[torch.from_numpy(mask)], ref[mask])
    both = DepthBoxes.cat([port[:4], port[4:]])
    np.testing.assert_allclose(both.tensor.numpy(), t, atol=TOL)
    assert len(both) == 12
    _cmp(port.clone(), ref.clone())
    with pytest.raises(AttributeError):
        port.tensor = None
