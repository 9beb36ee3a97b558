"""The two profilers that build on the port's bench
(``boxfusion_tpu_torch/tools/profile_gap1.py`` and ``profile_r5.py``), on
the CPU at toy size (CuTR-192, 256 px, a toy CLIP tower, 12 frames: the
first 3 keyframes at gap 1): each prints every line its JAX original prints,
in the same order, with a positive rate.

The ``det`` section's FLOPs of the 1-decoder-layer and 100-query CuTRs are
held against XLA's count of the JAX tool's programs in a ``slow`` case (two
more JAX compiles); the full forward's is held in tests/test_torch_bench.py.
"""
import dataclasses
import importlib.util
import os
import re

import pytest
import torch

from boxfusion_tpu_torch import bench

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ["--device", "cpu", "--frames", "12"]

# the lines tools/profile_gap1.py prints (:60, :73, :101), in its order
GAP1_TAGS = ("host pack only", "full loop (bench gap1)", "dispatch only (pre-packed)", "full loop, no labeler",
             "full loop, chunk=8")
# tools/profile_r5.py:66-71, printed at :83; then :98
R5_GAP1_TAGS = ("bucketed (default)", "fixed 128-crop pad", "bucketed, fusion off", "no labeler")
# tools/profile_r5.py:151-153, printed at :147; then :154
R5_DET_TAGS = ("full (6 dec layers, 300q)", "1 decoder layer", "100 queries")
# XLA's cost model also counts elementwise work (norms, softmax, activations),
# FlopCounterMode the products alone, and the products' share is smallest in
# the cut models: measured 0.9625 (1 decoder layer) and 0.9874 (100 queries),
# against 1.0063 for the full model (held at 2% in tests/test_torch_bench.py)
CUT_FLOP_RTOL = 0.05


def _printed(out: str) -> list:
    """The tool's own lines: the pipelines' ``run`` prints a "Cost:" line."""
    return [line for line in out.strip().splitlines() if not line.startswith("Cost:")]


def test_profile_gap1_prints_the_jax_tools_lines(capsys):
    from boxfusion_tpu_torch.tools import profile_gap1

    assert profile_gap1.main(TOY) == 0
    lines = _printed(capsys.readouterr().out)
    assert len(lines) == len(GAP1_TAGS)
    for line, tag in zip(lines, GAP1_TAGS):
        m = re.fullmatch(rf"{re.escape(tag)} +([0-9.]+) keyframes/s  \( *([0-9.]+) ms/kf\)", line)
        assert m and float(m.group(1)) > 0, line


def test_profile_r5_gap1_prints_the_jax_tools_lines(capsys):
    from boxfusion_tpu_torch.tools import profile_r5

    assert profile_r5.main(["gap1", *TOY]) == 0
    lines = _printed(capsys.readouterr().out)
    assert len(lines) == len(R5_GAP1_TAGS) + 1
    for line, tag in zip(lines, R5_GAP1_TAGS):
        m = re.fullmatch(rf"gap1 {re.escape(tag)} +([0-9.]+) keyframes/s  \( *([0-9.]+) ms/kf\)", line)
        assert m and float(m.group(1)) > 0, line
    m = re.fullmatch(r"gap20 headline \(bucketed\) +([0-9.]+) FPS", lines[-1])
    assert m and float(m.group(1)) > 0, lines[-1]


def test_profile_r5_stages_prints_the_bench_stage_table(capsys):
    import json

    from boxfusion_tpu_torch.tools import profile_r5

    assert profile_r5.main(["stages", *TOY]) == 0
    res = json.loads(capsys.readouterr().out)
    assert set(res["stage_ms"]) == {"clip_tower_32", "crop_resize_128", "step_assoc_plus_fusion",
                                    "step_assoc_only", "fusion_delta"}
    assert all(v >= 0 for v in res["stage_ms"].values())


def test_profile_r5_det_prints_the_jax_tools_lines(capsys):
    from boxfusion_tpu_torch.tools import profile_r5

    with torch.inference_mode():
        res = profile_r5.run("det", "cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(R5_DET_TAGS) + 1
    for line, tag in zip(lines, R5_DET_TAGS):
        m = re.fullmatch(rf"det {re.escape(tag)} +([0-9.]+) ms +([0-9.]+) GFLOP +([0-9.]+) TF/s", line)
        assert m and float(m.group(1)) > 0, line
    assert re.fullmatch(r"det decoder 5-layer delta: -?[0-9.]+ ms; queries300->100 delta: -?[0-9.]+ ms", lines[-1])
    # the full forward counts what the bench's micro phase counts; the cut ones less
    model, batch = bench._build_model(torch.device("cpu"), bench._workload(False))
    with torch.inference_mode():
        full = bench._flops(bench._chained_forward(model, batch), torch.zeros(()))
    assert res["full"][1] == full
    assert res["1_decoder_layer"][1] < full and res["100_queries"][1] < full


@pytest.mark.slow
def test_profile_r5_det_flops_match_jax_cost_analysis():
    """Each cut CuTR's FLOPs within CUT_FLOP_RTOL of XLA's count of the JAX
    tool's ``chained`` program (tools/profile_r5.py:111-132)."""
    import jax
    import jax.numpy as jnp

    from boxfusion_tpu.models.cutr import make_cutr as jax_make_cutr
    from boxfusion_tpu_torch.models.cutr import make_cutr

    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    wl = bench._workload(False)
    _, _, jbatch = jbench._build_model(False, wl)
    tbatch = bench._bench_batch(torch.device("cpu"), wl)
    for kw in (dict(num_decoder_layers=1), dict(num_queries=100)):
        model = jax_make_cutr(dimension=wl["dim"], depth_model=True, dtype="float32", **kw)
        params = jax.jit(model.init)(jax.random.PRNGKey(0), jbatch)
        want = jbench._compiled_flops(_jax_chained(model), params, jbatch, jnp.float32(0.0))
        tmodel = make_cutr(wl["dim"], depth_model=True, device="cpu", **kw)
        with torch.inference_mode():
            got = bench._flops(bench._chained_forward(tmodel, tbatch), torch.zeros(()))
        assert want > 1e9 and abs(got / want - 1) < CUT_FLOP_RTOL, (kw, got, want)


def _jax_chained(model):
    """The JAX tool's ``chained`` (tools/profile_r5.py:125-129) for ``model``."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(params, batch, eps):
        out = model.apply(params, dataclasses.replace(batch, image=batch.image + eps))
        dep = sum(jnp.sum(v).astype(jnp.float32) for v in jax.tree.leaves(out))
        return dep * 1e-12 + eps + 1e-3

    return chained
