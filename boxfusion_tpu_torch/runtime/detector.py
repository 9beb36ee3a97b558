"""CuTR detector wrapper: Frame -> detections (torch).

Port of ``boxfusion_tpu/runtime/detector.py``.  One call uploads the frame
(uint8 image, float32 depth, K, T_gravity) to the model's device, packages
it there (pixel normalization, square padding into the reference's
{256..1024} buckets, depth whitening) and runs the forward pass.  By default
the top-k detections come back as numpy (what the host engine takes); with
``device_output`` they stay tensors on the device and nothing is read back
(what the device engine takes).
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from boxfusion_tpu_torch.data.preprocess import (
    PIXEL_MEAN_U8,
    PIXEL_STD_U8,
    SQUARE_PAD_BUCKETS,
    package_frame,
    resolve_pad_and_ratio,
)
from boxfusion_tpu_torch.data.readers import Frame
from boxfusion_tpu_torch.models.cutr import CubifyTransformer
from boxfusion_tpu_torch.utils.device import DeviceLike, resolve_device

_TAKE = (
    "scores",
    "pred_classes",
    "pred_boxes",
    "pred_logits",
    "boxes3d",
    "R",
    "proj_xy",
    "object_desc",
)


class CuTRDetector:
    """Callable detector: Frame -> dict of arrays (camera-frame boxes).

    Output keys: scores, pred_classes, pred_boxes (xyxy), pred_logits,
    boxes3d (xyzlhw, camera frame), R, proj_xy, object_desc -- the fields
    the reference's ``Instances3D`` carries out of
    CubifyTransformer.inference (reference cubify_transformer.py:961-977).

    Args:
      model: a CuTR model; it is moved to ``device``.
      device: default "cuda" (raises if there is none).
      device_output: return tensors on the device, with no device-to-host
        read: the DevicePipeline's device-resident detect -> associate ->
        fuse path.
      export_image: additionally return the de-normalised [0, 255] padded
        image on the device under "image_dev", so that open-vocab labeling on
        the device (CLIP crops) needs no second upload.  Only meaningful with
        ``device_output`` (the numpy path would just drop it).
    """

    def __init__(self, model: CubifyTransformer, device: DeviceLike = None,
                 buckets=SQUARE_PAD_BUCKETS, device_output: bool = False,
                 export_image: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = buckets
        self.device_output = device_output
        self.export_image = export_image and device_output

    @torch.inference_mode()
    def __call__(self, frame: Frame) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
        image, depth = frame.image, frame.depth
        if not self.model.cfg.depth_model:
            # RGB-only CuTR: the stream's depth is not an input; the model
            # predicts its own depth whitening
            depth = None
        square, ratio = resolve_pad_and_ratio(image, depth, self.buckets)
        dev = self.device
        batch = package_frame(
            torch.as_tensor(np.ascontiguousarray(image)).to(dev),
            torch.as_tensor(np.asarray(depth, np.float32)).to(dev) if depth is not None else None,
            torch.as_tensor(np.asarray(frame.K, np.float32)).to(dev),
            torch.as_tensor(np.asarray(frame.T_gravity, np.float32)).to(dev),
            square,
            ratio,
        )
        out = self.model(batch)
        det = {k: out[k][0] for k in _TAKE}
        if not self.device_output:
            return {k: v.cpu().numpy() for k, v in det.items()}
        if self.export_image:
            det["image_dev"] = (batch.image[0] * torch.as_tensor(PIXEL_STD_U8, device=dev)
                                + torch.as_tensor(PIXEL_MEAN_U8, device=dev))
        return det
