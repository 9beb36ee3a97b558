"""Package-level checks of the PyTorch / CUDA port.

This file imports torch and the port only -- no JAX -- so that its card
tests (marker ``cuda``) also run on a GPU machine that has no JAX (the
suite's conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_package.py \
        tests/test_torch_tiled_attention.py

On a machine without a card they skip.
"""
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import boxfusion_tpu_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(boxfusion_tpu_torch.__path__, "boxfusion_tpu_torch.")
    )


def test_port_imports_no_jax_and_no_reference_package():
    """Every module imports in a fresh interpreter without pulling in jax,
    flax or the JAX package."""
    code = (
        "import importlib, json, sys\n"
        f"mods = {_all_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'boxfusion_tpu'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 49 and res["bad"] == [], res
    mods = _all_modules()
    for new in ("cli", "utils.io", "ops.attention_kernel", "models.clip.model",
                "models.clip.head", "models.clip.convert", "models.clip.text",
                "runtime.device_state", "runtime.device_step", "runtime.device_pipeline",
                "utils.checkpoint", "tools.attention_ablation"):
        assert f"boxfusion_tpu_torch.{new}" in mods, new


def test_entry_points_default_to_cuda_and_raise_without_it():
    """No silent CPU fallback: without device= the entry points want a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.fusion import optimize_boxes
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime import CuTRDetector, OnlinePipeline
    from boxfusion_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config/ca1m.yaml"))
    cfg["box_fusion"]._data["pst_path"] = None
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlinePipeline(cfg, OracleDetector(SyntheticSequence(n_frames=2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_cutr(192)
    with pytest.raises(RuntimeError, match="CUDA"):
        CuTRDetector(make_cutr(192, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        optimize_boxes(np.zeros((1, 6)), np.eye(3)[None], np.zeros((8, 6)), np.tile(np.eye(4), (1, 2, 1, 1)),
                       np.zeros((1, 2, 8, 2)), np.ones((1, 2)), np.ones(1, bool), np.eye(3), 10.0, 10.0)


def test_device_engine_entry_points_raise_without_a_card(tmp_path):
    """The device engine's entry points take the same rule: DevicePipeline,
    init_state and restore_pipeline_state want a card unless told "cpu".  The
    kernel wrapper is steered by where its tensors lie, as the other two are:
    a CPU tensor runs the plain twin (and counts no launch), a tensor on any
    other non-CUDA device is refused -- nothing carries on quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.runtime import DevicePipeline
    from boxfusion_tpu_torch.runtime.device_state import init_state
    from boxfusion_tpu_torch.tools.attention_ablation import reference_attention, tiled_attention
    from boxfusion_tpu_torch.utils.checkpoint import restore_pipeline_state, save_pipeline_state
    from boxfusion_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config/ca1m.yaml"))
    cfg["box_fusion"]._data["pst_path"] = None
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePipeline(cfg, OracleDetector(SyntheticSequence(n_frames=2)), capacity=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(8, 5, 16)
    save_pipeline_state(str(tmp_path / "s.pt"), init_state(8, 5, 16, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_pipeline_state(str(tmp_path / "s.pt"))

    q, k, v = torch.randn(3, 2, 70, 64, generator=torch.Generator().manual_seed(0)).unbind(0)
    before = tiled_attention.launches
    torch.testing.assert_close(tiled_attention(q, k, v), reference_attention(q, k, v))
    assert tiled_attention.launches == before
    m = torch.zeros(2, 70, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tiled_attention(m, m, m)
    with pytest.raises(ValueError, match="head width"):
        tiled_attention(q[..., :24], k[..., :24], v[..., :24])


def test_kernel_build_is_keyed_by_source_and_flags():
    from boxfusion_tpu_torch.ops import build

    path = build.library_path("fitness_kernel")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libfitness_kernel-")
    assert path.suffix == ".so"
    flags = " ".join(build.NVCC_FLAGS["fitness_kernel"])
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "use_fast_math" not in flags
    assert (build.CSRC_DIR / build.SOURCES["fitness_kernel"]).exists()
    # flags are per source: the fitness kernel's are exactly what they were when
    # every source shared one tuple (its library name, a hash of source and
    # flags, does not move); the attention kernel keeps FMA contraction
    assert flags == ("-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared "
                     "-Xcompiler -fPIC -fmad=false -Xptxas -v")
    attn = " ".join(build.NVCC_FLAGS["attention_kernel"])
    assert "arch=compute_90a,code=sm_90a" in attn and "fmad" not in attn
    assert "use_fast_math" not in attn and set(build.NVCC_FLAGS) == set(build.SOURCES)
    assert build.library_path("attention_kernel").name.startswith("libattention_kernel-")
    assert (build.CSRC_DIR / build.SOURCES["attention_kernel"]).exists()
    tiled = " ".join(build.NVCC_FLAGS["tiled_attention_kernel"])
    assert "arch=compute_90a,code=sm_90a" in tiled and "fmad" not in tiled
    assert "use_fast_math" not in tiled
    assert (build.CSRC_DIR / build.SOURCES["tiled_attention_kernel"]).exists()


def test_kernel_build_hash_sees_the_headers(tmp_path, monkeypatch):
    """A source may include any csrc/*.cuh: a changed header gives every
    library a new path (so a stale .so is not loaded), an unchanged tree the
    same one."""
    import shutil

    from boxfusion_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    assert (csrc / "hopper_common.cuh").exists()
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    assert before == {name: build.library_path(name) for name in build.SOURCES}
    with open(csrc / "hopper_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(after[name] != before[name] for name in build.SOURCES)
    assert all(after[name].name.startswith(f"lib{name}-") for name in build.SOURCES)


def test_wrapper_rejects_unsupported_devices():
    from boxfusion_tpu_torch.ops.fitness_kernel import fitness_cells

    u = torch.zeros(1, 8, 128, device="meta")
    args = (u, u, torch.zeros(1, 8, 2, device="meta"), torch.zeros(1, 12, 3, device="meta"),
            torch.zeros(1, 12, device="meta"), torch.zeros(1, 1, device="meta"),
            torch.zeros(1, 1, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fitness_cells(*args)


@pytest.mark.cuda
def test_fitness_kernel_on_card_matches_twin():
    """The CUDA kernel against its plain twin at the main path's shapes
    (16 objects x 10 view slots x 1024 particles), and a launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sys.path.insert(0, REPO)
    from chip_smoke import FITNESS_TOL, fitness_scene

    from boxfusion_tpu_torch.ops.fitness_kernel import fitness_cells, fitness_cells_reference

    args = fitness_scene(torch.device("cuda"))
    before = fitness_cells.launches
    got = fitness_cells(*args)
    want = fitness_cells_reference(*args)
    torch.cuda.synchronize()
    assert fitness_cells.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= FITNESS_TOL


@pytest.mark.cuda
def test_attention_kernel_on_card_matches_twin():
    """Both attention kernels (float32 FMA, bfloat16 tensor cores) against
    the twin at chip_smoke's shapes and tolerances, strided chunk views as
    the CLIP block passes them, and a launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sys.path.insert(0, REPO)
    from chip_smoke import ATTENTION_CASES, attention_case, attention_tolerance

    from boxfusion_tpu_torch.ops.attention_kernel import (
        whole_seq_attention,
        whole_seq_attention_reference,
    )

    for case in ATTENTION_CASES:
        q, k, v, heads, scale = attention_case(torch.device("cuda"), case)
        before = whole_seq_attention.launches
        got = whole_seq_attention(q, k, v, heads, scale)
        want = whole_seq_attention_reference(q, k, v, heads, scale)
        torch.cuda.synchronize()
        assert whole_seq_attention.launches == before + 1
        assert got.dtype == q.dtype and got.shape == q.shape and torch.isfinite(got).all()
        atol, rtol = attention_tolerance(q.dtype)
        excess = (got.float() - want.float()).abs() - (atol + rtol * want.float().abs())
        assert float(excess.max()) <= 0, case


@pytest.mark.cuda
def test_optimize_boxes_on_card_matches_cpu():
    """One fused batch on the card (kernel) and on the CPU (twin): the same
    decisions, coordinates within the cross-stack PST bound 5e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from boxfusion_tpu_torch.fusion import optimize_boxes, synthesize_pst
    from boxfusion_tpu_torch.fusion.optimizer import PSTOptConfig

    rng = np.random.RandomState(0)
    n, V = 4, 5
    init = np.concatenate([rng.uniform(-0.5, 0.5, (n, 3)), rng.uniform(0.3, 0.6, (n, 3))], 1)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, V, 1, 1))
    poses[:, :, 2, 3] = -3.0
    poses[:, :, 0, 3] = np.linspace(-1, 1, V)
    corners = rng.uniform(150, 350, (n, V, 8, 2)).astype(np.float32)
    args = (init, np.tile(np.eye(3), (n, 1, 1)), synthesize_pst(1024), poses, corners,
            np.ones((n, V)), np.ones(n, bool), np.array([[300.0, 0, 256], [0, 300.0, 192], [0, 0, 1]]),
            384.0, 512.0, PSTOptConfig(iters=6))
    gx, gu = optimize_boxes(*args, device="cuda")
    cx, cu = optimize_boxes(*args, device="cpu")
    np.testing.assert_array_equal(gu.cpu().numpy(), cu.numpy())
    np.testing.assert_allclose(gx.cpu().numpy(), cx.numpy(), atol=5e-3, rtol=0)
