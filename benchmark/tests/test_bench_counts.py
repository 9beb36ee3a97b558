"""The yardstick's counts against what the plain reference dispatches.

    python -m pytest benchmark/tests -q

FLOPs of CuTR (at a pad whose windows fit, and at one whose windows need
padding, as 640 does for 518x392 frames) and of CLIP towers (GELU and
quick-GELU) against ``FlopCounterMode`` on the reference modules at small
widths; the roofline's FLOP and byte counts; the PST search's operation
count on a hand-counted case.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import counts
from benchmark.reference.models.clip.model import CLIPConfig, CLIPImageTower
from benchmark.reference.models.cutr.model import CubifyTransformer, CuTRConfig, FrameBatch


def _counted(fn, *args) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("pad", [256, 320])
def test_cutr_flops_match_the_reference(pad):
    torch.manual_seed(0)
    model = CubifyTransformer(CuTRConfig(embed_dim=192)).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    f = 0.6 * pad
    batch = FrameBatch(image=torch.randn(1, pad, pad, 3), depth=torch.randn(1, pad, pad, 1),
                       K=torch.tensor([[[f, 0, pad / 2], [0, f, pad / 2], [0, 0, 1.0]]]),
                       image_hw=torch.tensor([[0.75 * pad, float(pad)]]), depth_params=torch.tensor([[2.0, 0.5]]),
                       T_gravity=torch.eye(3)[None])
    assert counts.cutr_flops(pad, 1, embed_dim=192) == _counted(model, batch)


@pytest.mark.parametrize("quick_gelu, layers", [(False, 2), (True, 1)])
def test_tower_flops_match_the_reference(quick_gelu, layers):
    cfg = CLIPConfig(image_size=224, patch=32, width=64, layers=layers, heads=2, embed_dim=32, quick_gelu=quick_gelu)
    tower = CLIPImageTower(cfg).eval()
    for p in tower.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    assert counts.tower_flops(3, 224, 32, 64, layers, 32) == _counted(tower, torch.randn(3, 224, 224, 3))


def test_published_widths_count():
    # CuTR-768 at the 512 pad: 343.0 GFLOP, the figure PERF.md's bench
    # record read with FlopCounterMode on the port (chip call 12.1)
    assert round(counts.cutr_flops(512) / 1e9, 1) == 343.0
    # ViT-H-14 a crop: 2 x 632 M parameters x 257 tokens plus attention
    per_crop = counts.tower_flops(1, 224, 14, 1280, 32, 1024)
    assert 320e9 < per_crop < 345e9


def test_attention_work():
    flops, bytes_ = counts.attention_work(batch=2, tokens=257, heads=16, head_dim=80, elem_bytes=2)
    assert flops == 2 * 2 * 2 * 16 * 257 * 257 * 80        # QK^T and PV, 2 FLOPs a product
    assert bytes_ == 4 * 2 * 257 * 16 * 80 * 2             # Q, K, V in and O out, bfloat16


def test_pst_search_ops_by_hand():
    # one object, two live views of three, 5 and 0 valid observed planes, two
    # iterations of 128 particles; a second object that never ran
    ops = counts.pst_search_ops([2, 0], [[1, 1, 0], [1, 0, 0]], 128, [[5, 0, 7], [3, 0, 0]])
    per_cell = counts.CELL_OPS + counts.OPS_PER_LIVE_PARTICLE
    want = 2 * 128 * (2 * per_cell + 5 * counts.OPS_PER_VALID_OBS_PLANE + counts.PARTICLE_OPS)
    assert ops == want
    assert counts.PARTICLE_OPS == 336 and counts.CELL_OPS == 264  # ops/pst_search.py's
