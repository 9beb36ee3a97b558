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
from pathlib import Path

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
    flax, the JAX package, or the repo's ``tools/`` and ``tests/`` (the JAX
    tools and the black-box harness)."""
    code = (
        "import importlib, json, sys\n"
        f"mods = {_all_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'boxfusion_tpu', 'tools', 'tests'))\n"
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
                "utils.checkpoint", "tools.attention_ablation", "ops.pst_search",
                "runtime.fused", "runtime.batched", "eval.ap3d", "eval.runner", "eval.__main__",
                "train", "train.loss", "train.step", "train.__main__", "parallel", "parallel.mesh",
                "data_process", "data_process.prep", "data_process.gt_filter", "data_process.__main__",
                "structures", "structures.instances", "structures.boxes3d", "structures.sensor",
                "native", "native.loader", "utils.profiling", "utils.viz", "tools.common",
                "tools.trace_keyframe", "tools.trace_stress", "tools.profile_keyframe",
                "tools.profile_stress", "tools.profile_detector", "tools.profile_fused",
                "tools.profile_stress_ablate", "tools.profile_clip_attn", "tools.profile_bench_real",
                "tools.blackbox", "tools.build_parity_fixture", "tools.run_blackbox_parity",
                "tools.diagnose_parity_band", "tools.profile_host_engine", "bench", "tools.profile_gap1",
                "tools.profile_r5"):
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
    det = CuTRDetector(make_cutr(192, device="cpu"), device="cpu")
    from boxfusion_tpu_torch.eval import evaluate_sequences
    from boxfusion_tpu_torch.runtime import BatchedPipeline, FusedDevicePipeline

    with pytest.raises(RuntimeError, match="CUDA"):
        FusedDevicePipeline(cfg, det)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedPipeline(cfg, det, n_lanes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_sequences(cfg, [SyntheticSequence(n_frames=2)], lambda s: OracleDetector(s))
    from boxfusion_tpu_torch.train.__main__ import main as train_main

    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--steps", "1", "--batch", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        optimize_boxes(np.zeros((1, 6)), np.eye(3)[None], np.zeros((8, 6)), np.tile(np.eye(4), (1, 2, 1, 1)),
                       np.zeros((1, 2, 8, 2)), np.ones((1, 2)), np.ones(1, bool), np.eye(3), 10.0, 10.0)
    # the ported tracers and profilers (each also takes --device cpu)
    import importlib

    from boxfusion_tpu_torch.utils import profiling

    for tool in ("trace_keyframe", "trace_stress", "profile_keyframe", "profile_stress",
                 "profile_detector", "profile_fused"):
        with pytest.raises(RuntimeError, match="CUDA"):
            importlib.import_module(f"boxfusion_tpu_torch.tools.{tool}").main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace():
            pass


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


def test_refuse_autograd_logic():
    """The check the attention wrappers make on the card before a launch:
    it raises under grad mode when an input requires grad (the kernel
    defines no gradient, so backward would pass nothing through it), and
    passes under no_grad, inference_mode and for inputs without grad.  On
    CPU tensors the wrappers run their differentiable twins, unchanged."""
    from boxfusion_tpu_torch.ops.attention_kernel import (
        whole_seq_attention,
        whole_seq_attention_reference,
    )
    from boxfusion_tpu_torch.tools.attention_ablation import tiled_attention
    from boxfusion_tpu_torch.utils.device import refuse_autograd

    x = torch.randn(2, 3, requires_grad=True)
    y = torch.randn(2, 3)
    with pytest.raises(RuntimeError, match="no gradient"):
        refuse_autograd("kernel", y, x)
    refuse_autograd("kernel", y, y)
    with torch.no_grad():
        refuse_autograd("kernel", x, y)
    with torch.inference_mode():
        refuse_autograd("kernel", torch.randn(2, 3), y)

    q = torch.randn(2, 17, 128, requires_grad=True)
    out = whole_seq_attention(q, q, q, 2, 64 ** -0.5)
    torch.testing.assert_close(out, whole_seq_attention_reference(q, q, q, 2, 64 ** -0.5))
    out.sum().backward()
    assert q.grad is not None and float(q.grad.abs().sum()) > 0
    t = torch.randn(2, 17, 64, requires_grad=True)
    tiled_attention(t, t, t).sum().backward()
    assert t.grad is not None


@pytest.mark.cuda
def test_attention_kernels_refuse_autograd_on_card():
    """On the card both attention wrappers raise on inputs that require grad
    under grad mode, and launch under no_grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention
    from boxfusion_tpu_torch.tools.attention_ablation import tiled_attention

    q = torch.randn(2, 65, 128, device="cuda", requires_grad=True)
    t = torch.randn(2, 65, 64, device="cuda", requires_grad=True)
    before = (whole_seq_attention.launches, tiled_attention.launches)
    with pytest.raises(RuntimeError, match="no gradient"):
        whole_seq_attention(q, q, q, 2, 64 ** -0.5)
    with pytest.raises(RuntimeError, match="no gradient"):
        tiled_attention(t, t, t)
    assert (whole_seq_attention.launches, tiled_attention.launches) == before
    with torch.no_grad():
        whole_seq_attention(q, q, q, 2, 64 ** -0.5)
        tiled_attention(t, t, t)
    torch.cuda.synchronize()
    assert (whole_seq_attention.launches, tiled_attention.launches) == (before[0] + 1, before[1] + 1)


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
    # the search kernel runs the fitness body: the same flags, -fmad=false
    assert " ".join(build.NVCC_FLAGS["pst_search_kernel"]) == flags
    assert (build.CSRC_DIR / build.SOURCES["pst_search_kernel"]).exists()
    tiled = " ".join(build.NVCC_FLAGS["tiled_attention_kernel"])
    assert "arch=compute_90a,code=sm_90a" in tiled and "fmad" not in tiled
    assert "use_fast_math" not in tiled
    assert (build.CSRC_DIR / build.SOURCES["tiled_attention_kernel"]).exists()
    # the step kernel decides by float32 pose tests: -fmad=false, fmaf where it means one
    assert " ".join(build.NVCC_FLAGS["step_kernel"]) == flags
    assert (build.CSRC_DIR / build.SOURCES["step_kernel"]).exists()


def test_native_build_is_keyed_by_source_flags_and_toolchain(tmp_path, monkeypatch):
    """The native loader's library lives in _build/, named by a hash of
    loader.cc, the g++ flags and the compiler's version and target: any of
    them changed names another library, so a stale or foreign one is never
    loaded."""
    from boxfusion_tpu_torch.native import loader

    path = loader.library_path("g++ 13.2.0 x86_64-linux-gnu")
    assert path.parent == loader.BUILD_DIR and path.name.startswith("libbfloader-") and path.suffix == ".so"
    assert loader.BUILD_DIR == Path(boxfusion_tpu_torch.__file__).parent / "_build"
    assert loader.library_path("g++ 13.2.0 x86_64-linux-gnu") == path
    assert loader.library_path("g++ 14.1.0 x86_64-linux-gnu") != path
    assert loader.library_path("g++ 13.2.0 aarch64-linux-gnu") != path
    monkeypatch.setattr(loader, "GXX_FLAGS", loader.GXX_FLAGS + ("-g",))
    assert loader.library_path("g++ 13.2.0 x86_64-linux-gnu") != path
    monkeypatch.undo()
    src = tmp_path / "loader.cc"
    src.write_bytes(loader.SOURCE.read_bytes() + b"\n")
    monkeypatch.setattr(loader, "SOURCE", src)
    assert loader.library_path("g++ 13.2.0 x86_64-linux-gnu") != path
    assert " ".join(loader.GXX_FLAGS + loader.LINK_FLAGS) == "-O3 -shared -fPIC -lpng -ljpeg -lz"


def test_native_loader_source_is_the_jax_packages():
    """boxfusion_tpu_torch/native/loader.cc is a byte-for-byte copy."""
    ours = Path(REPO, "boxfusion_tpu_torch", "native", "loader.cc").read_bytes()
    assert ours == Path(REPO, "boxfusion_tpu", "native", "loader.cc").read_bytes()


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
