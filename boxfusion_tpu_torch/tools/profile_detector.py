"""Microbenchmark of the CuTR detector call: transfer vs dispatch vs compute.

Port of ``tools/profile_detector.py``: CuTR-768 in bfloat16 at 512 px on a
card (192 in float32 at 256 px on the CPU), random weights, ``device_output``,
30 synthetic frames.  Prints ms per call of (a) the detector call pipelined
(one synchronisation at the end), (b) the call synchronised each time, (c)
the four host-to-device copies alone, (d) packaging + forward on inputs
already on the device, (e) the bare forward on a resident ``FrameBatch``.

    python -m boxfusion_tpu_torch.tools.profile_detector
    python -m boxfusion_tpu_torch.tools.profile_detector --device cpu --frames 3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from boxfusion_tpu_torch.tools.common import keyframes, sync
from boxfusion_tpu_torch.utils.device import resolve_device


def run(device=None, n=30, size=None, dim=None) -> dict:
    from boxfusion_tpu_torch.data.preprocess import package_frame, resolve_pad_and_ratio
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector

    dev = resolve_device(device)
    card = dev.type == "cuda"
    size = (512 if card else 256) if size is None else size
    dim = (768 if card else 192) if dim is None else dim
    _, frames, _ = keyframes(n, size, 1)
    model = make_cutr(dim, depth_model=True, device=dev, dtype="bfloat16" if card else "float32")
    det = CuTRDetector(model, device=dev, device_output=True)
    ms = {}

    def per_call(name, body, sync_each=False):
        body(frames[0])  # warm
        sync(dev)
        t0 = time.perf_counter()
        for fr in frames:
            body(fr)
            if sync_each:
                sync(dev)
        sync(dev)
        ms[name] = (time.perf_counter() - t0) / n * 1000

    def upload(fr):
        return tuple(torch.as_tensor(x).to(dev) for x in (
            np.ascontiguousarray(fr.image), np.asarray(fr.depth, np.float32),
            np.asarray(fr.K, np.float32), np.asarray(fr.T_gravity, np.float32)))

    per_call("detector pipelined", det)
    print(f"detector pipelined:        {ms['detector pipelined']:7.2f} ms/call")
    per_call("detector sync", det, sync_each=True)
    print(f"detector sync:             {ms['detector sync']:7.2f} ms/call")
    per_call("upload tuple", upload)
    print(f"upload tuple:              {ms['upload tuple']:7.2f} ms/call")

    fr0 = frames[0]
    square, ratio = resolve_pad_and_ratio(fr0.image, fr0.depth, det.buckets)
    resident = upload(fr0)
    per_call("package+forward (dev inputs)", lambda fr: model(package_frame(*resident, square, ratio)))
    print(f"package+fwd (dev inputs):  {ms['package+forward (dev inputs)']:7.2f} ms/call")
    batch = package_frame(*resident, square, ratio)
    per_call("forward (resident)", lambda fr: model(batch))
    print(f"model forward (resident):  {ms['forward (resident)']:7.2f} ms/call")
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--size", type=int, default=None, help="default 512 on a card, 256 on the CPU")
    ap.add_argument("--dim", type=int, default=None, help="default 768 on a card, 192 on the CPU")
    a = ap.parse_args(argv)
    with torch.inference_mode():
        run(a.device, a.frames, a.size, a.dim)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
