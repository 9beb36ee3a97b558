"""The towers' residual add and LayerNorm as one kernel
(ops/layer_norm_kernel.py) and its plain twin.

This file imports torch and the port only -- no JAX -- so that its card tests
(marker ``cuda``) also run on a GPU machine that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_layer_norm_kernel.py

On the CPU the wrapper runs its twin, the add and ``LayerNorm`` the blocks
ran before; tests/test_torch_clip.py and tests/test_torch_siglip.py hold the
towers built on it to the JAX package and to the harness's reference.  On
the card the kernel is held to its twin on the same tensors (s bit-equal, y
within one bfloat16 ulp, ``chip_smoke.bf16_ulp``), and each of the three
towers of the benchmark's configurations is held to itself with the twin in
the kernel's place.
"""
import os
import sys

import pytest
import torch

from boxfusion_tpu_torch.models.clip import model as clip_model
from boxfusion_tpu_torch.models.clip.model import CLIPConfig, add_norm
from boxfusion_tpu_torch.models.clip.siglip import SigLIPConfig
from boxfusion_tpu_torch.models.cutr.layers import LayerNorm
from boxfusion_tpu_torch.ops import layer_norm_kernel as lnk

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import LAYER_NORM_CASES, hold_layer_norm, layer_norm_inputs  # noqa: E402

# the tower tests' bfloat16 bound on the embedding, relative L2 over a batch
# (tests/test_torch_siglip.py:REL_TOL)
TOWER_REL_TOL = 3e-2


# --------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_runs_its_twin_on_cpu(residual, dtype):
    """CPU tensors take the twin, bit for bit the add and ``LayerNorm`` of
    the blocks (``add_norm``'s composition), and launch nothing."""
    x, d, w, b = layer_norm_inputs("cpu", 7, 24, residual)
    x, d = x.to(dtype), None if d is None else d.to(dtype)
    norm = LayerNorm(24, eps=1e-6, dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    before = lnk.add_layer_norm.launches
    s, y = lnk.add_layer_norm(x, d, w, b, 1e-6)
    assert lnk.add_layer_norm.launches == before
    s_want = x if d is None else x + d
    assert torch.equal(s, s_want) and torch.equal(y, norm(s_want))
    with torch.no_grad():
        s2, y2 = add_norm(x, d, norm)
    assert torch.equal(s2, s_want) and torch.equal(y2, y)
    with pytest.raises(ValueError):
        lnk.add_layer_norm(x, x[:, :8], w, b, 1e-6)
    with pytest.raises(ValueError):
        lnk.add_layer_norm(x, d, w.double(), b, 1e-6)


# ------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 97 * 257, 100 * 729])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("width", [1024, 1152, 1280])
def test_kernel_matches_twin(width, eps, residual, rows):
    """s bit-equal to x + d, y within one bfloat16 ulp of the twin's, one
    launch counted a call with rows (none without)."""
    dev = _card()
    x, d, w, b = layer_norm_inputs(dev, rows, width, residual, seed=width + rows)
    before = lnk.add_layer_norm.launches
    hold_layer_norm(x, d, w, b, eps, f"{rows} x {width}")
    assert lnk.add_layer_norm.launches == before + (rows > 0)


@pytest.mark.cuda
def test_kernel_reads_strided_and_offset_inputs():
    """A column slice (rows strided) and a view 2 bytes into its storage are
    copied before the launch; the result is the twin's on the same views."""
    dev = _card()
    x, d, w, b = layer_norm_inputs(dev, 33, 2 * 1152)
    xs = x[:, :1152]                     # rows 2 x 1152 apart
    ds = d.reshape(-1)[1:33 * 1152 + 1].reshape(33, 1152)  # 2 bytes off the allocation
    assert not xs.is_contiguous() and ds.data_ptr() % 16 != 0
    hold_layer_norm(xs, ds, w[:1152], b[:1152], 1e-6, "strided")


@pytest.mark.cuda
def test_refusals_and_what_add_norm_takes():
    """float32 and rows that need a gradient are refused by the wrapper;
    ``add_norm`` routes them to the twin instead (no launch), and a bfloat16
    stream outside autograd to the kernel."""
    dev = _card()
    x, d, w, b = layer_norm_inputs(dev, 5, 1024)
    with pytest.raises(TypeError):
        lnk.add_layer_norm(x.float(), d.float(), w, b, 1e-5)
    with pytest.raises(ValueError):
        lnk.add_layer_norm(x[:, :1020], d[:, :1020], w[:1020], b[:1020], 1e-5)
    xg = x.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        lnk.add_layer_norm(xg, d, w, b, 1e-5)

    norm = LayerNorm(1024, eps=1e-5, dtype=torch.bfloat16).to(dev)
    norm32 = LayerNorm(1024, eps=1e-5, dtype=torch.float32).to(dev)
    before = lnk.add_layer_norm.launches
    s, y = add_norm(xg, d, norm)          # grad mode, an input needs grad: the twin
    assert y.requires_grad and torch.equal(s, x + d)
    add_norm(x.float(), d.float(), norm32)  # float32: the twin
    assert lnk.add_layer_norm.launches == before
    with torch.inference_mode():
        add_norm(x, d, norm)                # the kernel
    assert lnk.add_layer_norm.launches == before + 1


TOWERS = {
    "vit_h14": lambda: CLIPConfig(dtype="bfloat16"),
    "vit_l14": lambda: CLIPConfig(patch=14, width=1024, layers=24, heads=16, embed_dim=768,
                                  quick_gelu=True, dtype="bfloat16"),
    "siglip_so400m": lambda: SigLIPConfig(dtype="bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tower", list(TOWERS))
def test_tower_with_kernel_matches_tower_with_twin(tower, monkeypatch):
    """Each tower of the benchmark's configurations at full width, random
    weights, 4 crops: 2 launches a block and one more, and the embeddings
    within the tower tests' bfloat16 bound of the same tower with the twin in
    the kernel's place."""
    dev = _card()
    cfg = TOWERS[tower]()
    assert cfg.width == LAYER_NORM_CASES[tower][1]
    with torch.device(dev):
        net = cfg.image_tower()
    net.init_random(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    crops = torch.randn(4, cfg.image_size, cfg.image_size, 3, generator=gen, device=dev)
    before = lnk.add_layer_norm.launches
    with torch.inference_mode():
        got = net(crops)
    assert lnk.add_layer_norm.launches == before + 2 * cfg.layers + 1
    monkeypatch.setattr(clip_model, "add_layer_norm", lnk.add_layer_norm_reference)
    with torch.inference_mode():
        want = net(crops)
    assert lnk.add_layer_norm.launches == before + 2 * cfg.layers + 1
    rel = float((got - want).norm() / want.norm())
    assert torch.isfinite(got).all() and rel <= TOWER_REL_TOL, rel
