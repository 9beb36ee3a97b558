"""The SigLIP SO400M/14@384 labeler through the benchmark's model seam.

    python -m pytest benchmark/tests/test_bench_siglip.py -q

The configuration ``ca1m-cutr768-siglip-so400m384`` names the family
``siglip_vit`` (``families/siglip_vit.py``): the family builds the port's
tower and the plain reference with the same parameter names and shapes at
the published widths (on ``meta``), counts the tower's FLOPs as written out
here by hand, names the tower's one attention shape and a probe site that
exists, and a toy-sized SigLIP cell runs through the harness on the CPU and
reads correct.
"""
import importlib
import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import weights
from benchmark.harness.spec import BENCH_DIR, REPO, load_cell, load_families
from benchmark.tests.toycell import write_toy

CPU = torch.device("cpu")
NAME = "ca1m-cutr768-siglip-so400m384"
# a toy SigLIP labeler: SigLIP's traits (no class token, heads of 72, an MLP
# that is not 4 x width, eps 1e-6, the pool head) at a CPU size
TOY_SIGLIP = dict(family="siglip_vit", arch="toy SigLIP", image_size=56, patch=14, width=144, layers=2, heads=2,
                  mlp_width=200, ln_eps=1e-6, image_mean=[0.5, 0.5, 0.5], image_std=[0.5, 0.5, 0.5],
                  embed_dim=144, dtype="bfloat16", n_classes=8, sim_thres=0.0)


def _config() -> dict:
    with open(os.path.join(BENCH_DIR, "configs", NAME + ".json")) as f:
        return json.load(f)


def test_the_family_route_builds_program_and_reference_alike():
    config = _config()
    lab = config["labeler"]
    fam = load_families(config).labeler
    prog, ref = fam.program(lab, "meta"), fam.reference(lab, torch.float32, "meta")
    shapes = [(n, tuple(p.shape)) for n, p in prog.named_parameters()]
    assert shapes == [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    assert set(fam.table(ref)) == {n for n, _ in shapes}
    d = dict(shapes)
    assert d["positional_embedding"] == (729, 1152) and d["head.probe"] == (1, 1, 1152)
    assert d["transformer.resblocks.26.mlp.c_fc.weight"] == (4304, 1152)
    assert "transformer.resblocks.27.ln_1.weight" not in d
    assert prog.cfg.embed_dim == lab["embed_dim"] == 1152
    assert config["reduced"] == [] and config["detector"] == load_cell("ca1m.scan.cluttered").config["detector"]


def test_flops_written_out_by_hand():
    """One call over 96 crops at T = 729 (27 x 27 patches of 14 px), D = 1152,
    MLP 4304, 27 blocks; the probe's query projection once a call."""
    lab = _config()["labeler"]
    T, D, M, P = 729, 1152, 4304, 14 * 14 * 3
    patch = 2 * T * P * D
    block = 2 * T * D * 3 * D + 4 * T * T * D + 2 * T * D * D + 2 * T * D * M + 2 * T * M * D
    pool = 2 * T * D * 2 * D + 4 * T * D + 2 * D * D + 2 * D * M + 2 * M * D
    want = 96 * (patch + 27 * block + pool) + 2 * D * D
    fam = load_families(_config()).labeler
    assert fam.flops(lab, 96) == want
    assert round(fam.flops(lab, 1) / 1e12, 4) == 0.6703


def test_flops_are_what_the_reference_dispatches():
    fam = load_families(_config()).labeler
    tower = fam.reference(TOY_SIGLIP, torch.float32, CPU)
    for p in tower.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        tower(torch.randn(3, 56, 56, 3))
    assert fam.flops(TOY_SIGLIP, 3) == counter.get_total_flops()


def test_attention_shape_and_probe_site():
    config = _config()
    fam = load_families(config).labeler
    assert fam.attention_shapes(config["labeler"]) == [(729, 72)]
    for site in fam.ATTENTION_SITES:
        module, name = site.rsplit(".", 1)
        assert callable(getattr(importlib.import_module(module), name)), site


def _toy_siglip_cell(root: str):
    """The toy cell of ``toycell.write_toy``, its labeler swapped for the toy
    SigLIP in the written configuration, and the pool head's metric read in
    it."""
    bench_json = write_toy(root)
    path = os.path.join(root, "configs", "toy.json")
    with open(path) as f:
        config = json.load(f)
    config["labeler"] = dict(TOY_SIGLIP)
    with open(path, "w") as f:
        json.dump(config, f)
    with open(bench_json) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] == "label_pool_launched_ms":
            m["workloads"] = ["toy.cell"]
    with open(bench_json, "w") as f:
        json.dump(bench, f)
    return load_cell("toy.cell", bench_json=bench_json, dirs=[root, BENCH_DIR])


def test_a_toy_siglip_cell_runs_correct(tmp_path):
    import benchmark.run as run

    cell = _toy_siglip_cell(str(tmp_path))
    assert cell.families.labeler.__file__ == os.path.join(BENCH_DIR, "families", "siglip_vit.py")
    for trace in (False, True):
        result = run.run_cell(cell, 2147483659, 4.0, trace, CPU)
        assert result["correct"], result["checks"]
        assert result["readings"]["judged_keyframes"] >= 1
    # on the CPU the span is found and nothing is launched on a device
    assert result["metrics"]["label_pool_launched_ms"]["value"] == 0.0
    assert result["metrics"]["keyframe_mfu"]["value"] > 0
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        assert any(w["name"] == "ca1m.siglip.scan.cluttered" and w["chips"] == 1 for w in json.load(f)["workloads"])
