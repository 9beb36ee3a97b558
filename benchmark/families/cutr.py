"""CuTR, the transformer of Cubify Anything (RGB-D or RGB): a detector family.

Section keys: ``embed_dim`` (the backbone's width), ``depth_model`` and
``dtype``; the other widths the section states are CuTR's defaults, which
``CuTRConfig`` and ``counts.cutr_flops`` hold.  The program is the port's
``CubifyTransformer`` behind its ``CuTRDetector``; the reference is the
plain copy under ``benchmark/reference/models/cutr/``.
"""
import torch

from benchmark.harness import counts, weights
from benchmark.harness.system import dtype_of


def program(section: dict, device) -> torch.nn.Module:
    from boxfusion_tpu_torch.models.cutr.model import CubifyTransformer, CuTRConfig

    with torch.device(device):
        model = CubifyTransformer(CuTRConfig(embed_dim=section["embed_dim"], depth_model=section["depth_model"],
                                             dtype=dtype_of(section["dtype"])))
    return model.to(device).eval()


def detector(section: dict, model: torch.nn.Module, device):
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector

    return CuTRDetector(model, device=device)


def reference(section: dict, dtype: torch.dtype, device) -> torch.nn.Module:
    from benchmark.reference.models.cutr.model import CubifyTransformer, CuTRConfig

    with torch.device(device):
        model = CubifyTransformer(CuTRConfig(embed_dim=section["embed_dim"], depth_model=section["depth_model"],
                                             dtype=dtype))
    return model.to(device).eval()


def table(reference_model: torch.nn.Module, lift: float) -> dict:
    return weights.cutr_table(reference_model, lift)


def flops(section: dict, pad: int, depth_ratio: int) -> int:
    return counts.cutr_flops(pad, depth_ratio, embed_dim=section["embed_dim"])
