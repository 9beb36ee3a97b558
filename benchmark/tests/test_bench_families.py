"""The model seam: each configuration's detector and labeler are built, filled,
counted and probed through the family files that the configuration names.

    python -m pytest benchmark/tests -q

The family route must give what the direct construction gave before the
seam, for both configurations of the benchmark: the same reference modules
(names and shapes, on ``meta``), the same weight tables and so the same
weights, the same FLOP counts, attention shapes and probe sites.  A labeler
family written as a new file next to the benchmark (``toycell.TOY_FAMILY``)
runs a toy cell through the harness with no file of the benchmark edited,
and a configuration that names no family, or one that is not there, is
refused before anything is built.
"""
import hashlib
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import counts, weights
from benchmark.harness.spec import BENCH_DIR, REPO, load_cell, load_families
from benchmark.tests.toycell import toy_cell

CPU = torch.device("cpu")
CONFIGS = ["ca1m-cutr768-vith14", "cubicle-cutr768-vitl14"]
CLIP_KEYS = ("image_size", "patch", "width", "layers", "heads", "embed_dim", "quick_gelu")


def _config(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def _direct(config: dict):
    """The reference's CuTR and CLIP tower on ``meta``, as the harness built
    them before the seam."""
    from benchmark.reference.models.clip.model import CLIPConfig, CLIPImageTower
    from benchmark.reference.models.cutr.model import CubifyTransformer, CuTRConfig

    det, lab = config["detector"], config["labeler"]
    with torch.device("meta"):
        cutr = CubifyTransformer(CuTRConfig(embed_dim=det["embed_dim"], depth_model=det["depth_model"]))
        tower = CLIPImageTower(CLIPConfig(**{k: lab[k] for k in CLIP_KEYS}, dtype=torch.float32))
    return cutr, tower


def _shapes(module: torch.nn.Module) -> list:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_family_route_builds_the_same_reference_and_tables(name):
    config = _config(name)
    families = load_families(config)
    det, lab = config["detector"], config["labeler"]
    cutr, tower = _direct(config)
    ref_det = families.detector.reference(det, torch.float32, "meta")
    ref_tower = families.labeler.reference(lab, torch.float32, "meta")
    assert _shapes(ref_det) == _shapes(cutr)
    assert _shapes(ref_tower) == _shapes(tower)
    assert families.detector.table(ref_det, 2.668) == weights.cutr_table(cutr, 2.668)
    assert families.labeler.table(ref_tower) == weights.clip_table(tower)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_family_route_fills_the_same_weights(name):
    """Bit for bit, at widths a CPU test holds (CuTR-192, a two-layer tower
    of the configuration's kind): the program's modules from the families
    against the port's classes built directly, each filled from the tables
    of the reference built directly."""
    from boxfusion_tpu_torch.models.clip.model import CLIPConfig, CLIPImageTower
    from boxfusion_tpu_torch.models.cutr.model import CubifyTransformer, CuTRConfig

    config = _config(name)
    config["detector"].update(embed_dim=192)
    config["labeler"].update(patch=32, width=64, layers=2, heads=2, embed_dim=32)
    det, lab = config["detector"], config["labeler"]
    families = load_families(config)
    ref_cutr, ref_tower = _direct(config)
    seed = int(config["weight_seed"])
    via = (families.detector.program(det, CPU), families.labeler.program(lab, CPU))
    weights.fill(via[0], families.detector.table(families.detector.reference(det, torch.float32, "meta"), 1.5),
                 seed, CPU)
    weights.fill(via[1], families.labeler.table(families.labeler.reference(lab, torch.float32, "meta")),
                 seed + 2, CPU)
    direct = (CubifyTransformer(CuTRConfig(embed_dim=192, depth_model=det["depth_model"], dtype=torch.bfloat16)),
              CLIPImageTower(CLIPConfig(**{k: lab[k] for k in CLIP_KEYS}, dtype=torch.bfloat16)))
    weights.fill(direct[0], weights.cutr_table(ref_cutr, 1.5), seed, CPU)
    weights.fill(direct[1], weights.clip_table(ref_tower), seed + 2, CPU)
    for a, b in zip(via, direct):
        assert type(a) is type(b) and a.cfg == b.cfg
        pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
        assert list(pa) == list(pb)
        assert all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_family_route_counts_the_same_flops(name):
    config = _config(name)
    families = load_families(config)
    det, lab = config["detector"], config["labeler"]
    for pad in (512, 640):
        for ratio in (1, 2):
            assert families.detector.flops(det, pad, ratio) == counts.cutr_flops(pad, ratio,
                                                                                embed_dim=det["embed_dim"])
    for crops in (32, 64, 96, 100):
        assert families.labeler.flops(lab, crops) == counts.tower_flops(
            crops, lab["image_size"], lab["patch"], lab["width"], lab["layers"], lab["embed_dim"])


@pytest.mark.parametrize("name, pairs", [("ca1m-cutr768-vith14", [(257, 80)]),
                                         ("cubicle-cutr768-vitl14", [(257, 64)])])
def test_the_family_route_names_the_same_attention(name, pairs):
    config = _config(name)
    families = load_families(config)
    assert families.labeler.attention_shapes(config["labeler"]) == pairs
    assert families.labeler.ATTENTION_SITES == ("boxfusion_tpu_torch.models.clip.model.whole_seq_attention",)


def _tree_digest(root: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_labeler_family_added_as_a_file_runs_a_correct_cell(tmp_path):
    import benchmark.run as run
    from benchmark.harness import traffic as traffic_mod
    from benchmark.harness.system import build_program

    before = _tree_digest(BENCH_DIR)
    cell = toy_cell(str(tmp_path), toy_labeler=True)
    assert cell.families.labeler.__file__ == str(tmp_path / "families" / "toy_vit.py")
    for trace in (False, True):
        result = run.run_cell(cell, 7, 4.0, trace, CPU)
        assert result["correct"], result["checks"]
        assert result["readings"]["judged_keyframes"] >= 1
    assert result["metrics"]["keyframe_mfu"]["value"] > 0

    # the family's FLOPs are what its reference tower dispatches
    lab = cell.config["labeler"]
    tower = cell.families.labeler.reference(lab, torch.float32, CPU)
    for p in tower.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        tower(torch.randn(3, 224, 224, 3))
    assert cell.families.labeler.flops(lab, 3) == counter.get_total_flops()

    # the probe records the tower's attention at the family's own site
    traffic = dict(cell.traffic, class_bias_lift=weights.lift_for(cell.config, cell.traffic))
    prog = build_program(cell.config, cell.families, traffic, CPU)
    profiled = run.profile_keyframes(prog, traffic_mod.make_scans(traffic, 7), 2, CPU)
    (tokens, head_width), = cell.families.labeler.attention_shapes(lab)
    assert profiled.attention and {a[1:] for a in profiled.attention} == {(tokens, lab["heads"], head_width, 2)}
    assert _tree_digest(BENCH_DIR) == before


@pytest.mark.parametrize("edit, words", [
    (lambda cfg: cfg["labeler"].update(family="no_such_family"), ["labeler family 'no_such_family' not found"]),
    (lambda cfg: cfg["detector"].pop("family"), ["its detector names no family"]),
])
def test_a_configuration_without_its_family_is_refused(tmp_path, edit, words):
    config = _config(CONFIGS[0])
    edit(config)
    (tmp_path / "configs").mkdir()
    with open(tmp_path / "configs" / "edited.json", "w") as f:
        json.dump(config, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"][0]["file"] = "configs/edited.json"
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    with pytest.raises(LookupError) as err:
        load_cell("ca1m.scan.cluttered", bench_json=str(tmp_path / "BENCHMARK.json"),
                  dirs=[str(tmp_path), BENCH_DIR])
    message = str(err.value)
    for w in words + [str(tmp_path), BENCH_DIR]:
        assert w in message, message

