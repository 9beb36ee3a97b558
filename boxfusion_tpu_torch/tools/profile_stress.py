"""Stage breakdown of the device-resident real-detector path under load.

Port of ``tools/profile_stress.py``.  CuTR (768 in bfloat16 at 512 px on a
card, 192 in float32 at 256 px on the CPU; random weights, seed 0)
with ``device_output`` feeds ``DevicePipeline``: all 100 top-k detections
enter association and fusion every keyframe (``score_thresh`` 0).  Prints the
end-to-end rate, the pipeline's own stage split (``DevicePipeline.timings``,
the host clock around each stage, of the median run), and each stage alone,
synchronised: preprocess (host + upload), the detector, the keyframe step
replaying identical detections.

The JAX tool first enables XLA's persistent compile cache; eager PyTorch
compiles no program, and the port's CUDA kernels are cached by
``ops/build.py`` under ``_build/``, so there is nothing to enable here.

    python -m boxfusion_tpu_torch.tools.profile_stress
    python -m boxfusion_tpu_torch.tools.profile_stress --device cpu --frames 41 --reps 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from boxfusion_tpu_torch.tools.common import keyframes, sync, tool_config
from boxfusion_tpu_torch.tools.trace_stress import DET_KEYS, replay
from boxfusion_tpu_torch.utils.device import resolve_device


def run(device, n_frames=200, size=None, dim=None, gap=20, reps=3) -> dict:
    from boxfusion_tpu_torch.data.preprocess import Preprocessor
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector
    from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline

    dev = resolve_device(device)
    card = dev.type == "cuda"
    size = (512 if card else 256) if size is None else size
    dim = (768 if card else 192) if dim is None else dim
    _, frames, kf = keyframes(n_frames, size, gap)
    model = make_cutr(dim, depth_model=True, device=dev, dtype="bfloat16" if card else "float32")
    detector = CuTRDetector(model, device=dev, device_output=True)
    cfg = tool_config(gap, stress=True)

    def run_pipe():
        pipe = DevicePipeline(cfg, detector, capacity=512, device=dev)
        t0 = time.perf_counter()
        for i, frame in enumerate(frames):
            if i % gap == 0:
                pipe.process_keyframe(frame)
            pipe.count += 1
        pipe.flush()
        sync(dev)
        return time.perf_counter() - t0, pipe.timings

    run_pipe()  # warm
    runs = sorted((run_pipe() for _ in range(reps)), key=lambda r: r[0])
    dt, timings = runs[len(runs) // 2]
    print(f"e2e (real CuTR, device-resident, 100 det/kf): {n_frames / dt:8.1f} FPS "
          f"({dt / len(kf) * 1000:.2f} ms/keyframe)")
    for stage, s in sorted(timings.items()):
        print(f"  stage {stage:<8} (host clock, DevicePipeline.timings): {s / len(kf) * 1000:7.2f} ms/kf")

    pre = Preprocessor(device=dev)
    t0 = time.perf_counter()
    for frame in kf:
        pre(frame.image, frame.depth, frame.K, frame.T_gravity)
    sync(dev)
    pre_ms = (time.perf_counter() - t0) / len(kf) * 1000
    print(f"preprocess (host+upload):   {pre_ms:7.2f} ms/kf")

    for frame in kf[:2]:
        detector(frame)
    sync(dev)
    t0 = time.perf_counter()
    for frame in kf:
        detector(frame)
    sync(dev)
    det_ms = (time.perf_counter() - t0) / len(kf) * 1000
    print(f"detector (pre+fwd):         {det_ms:7.2f} ms/kf")

    dets = [{k: v for k, v in detector(fr).items() if k in DET_KEYS} for fr in kf]
    kmax = int(cfg["detection"]["max_detections"])

    def step_only():
        pipe = DevicePipeline(cfg, lambda fr: None, capacity=512, device=dev)
        t0 = time.perf_counter()
        replay(pipe, kf, dets, kmax)
        return time.perf_counter() - t0

    step_only()  # warm
    step_ms = float(np.median([step_only() for _ in range(reps)])) / len(kf) * 1000
    print(f"keyframe step (assoc+fuse): {step_ms:7.2f} ms/kf")
    return dict(fps=n_frames / dt, timings=timings, preprocess_ms=pre_ms, detector_ms=det_ms, step_ms=step_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--size", type=int, default=None, help="default 512 on a card, 256 on the CPU")
    ap.add_argument("--dim", type=int, default=None, help="default 768 on a card, 192 on the CPU")
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    with torch.inference_mode():
        run(a.device, a.frames, a.size, a.dim, a.gap, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
