"""Where the host engine's time goes, beside the original BoxFusion's.

Port of ``tools/profile_host_engine.py``.  On the committed parity scene
(36 frames at 192x256, gap 7) with the committed trained fixture:

  1. the wall time of a warm host-engine run (``OnlinePipeline`` on
     ``--device``) split into detector / geometry / fusion / the rest (numpy
     association and bookkeeping);
  2. the detector's forward on one identical frame: the reference's own
     torch CuTR (float32, the CPU, ``torch.no_grad``) against the port's
     CuTR on ``--device`` (the card synchronised after each call);
  3. the cProfile top functions of a third run.

Writes the JSON to ``--out`` (default ``<workdir>/HOST_PROFILE.json``).
Needs the original BoxFusion at ``blackbox.REF``; without it the tool prints
one line naming the missing path and exits with status 2 before any work.

    python -m boxfusion_tpu_torch.tools.profile_host_engine
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time

from boxfusion_tpu_torch.tools import blackbox
from boxfusion_tpu_torch.tools.common import REPO, sync
from boxfusion_tpu_torch.tools.diagnose_parity_band import FIXTURE, load_fixture_state_dict
from boxfusion_tpu_torch.utils.device import resolve_device

GAP = 7
N_FRAMES = 36
HW = (192, 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the port's host engine runs (the reference: the CPU)")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "blackbox_parity"))
    ap.add_argument("--out", default=None, help="default: <workdir>/HOST_PROFILE.json")
    ap.add_argument("--reps", type=int, default=8, help="forwards timed in part 2")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    missing = blackbox.reference_missing("profile_host_engine")
    if missing:
        print(missing, file=sys.stderr)
        return 2

    import torch
    import yaml

    from boxfusion_tpu_torch.data.readers import CA1MDataset
    from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict
    from boxfusion_tpu_torch.runtime import CuTRDetector, OnlinePipeline
    from boxfusion_tpu_torch.utils.config import load_config

    root = args.workdir
    seqdir = os.path.join(root, blackbox.SEQ)
    if not os.path.isdir(seqdir):
        os.makedirs(root, exist_ok=True)
        blackbox.write_scene(seqdir, n_frames=N_FRAMES, image_hw=HW)
    cfg_path = blackbox.write_config(os.path.join(root, "hostprof.yaml"), datadir=seqdir,
                                     output_dir=os.path.join(root, "hostprof_out"), gap=GAP, image_hw=HW)
    cfg = load_config(cfg_path)
    detector = CuTRDetector(load_torch_state_dict(load_fixture_state_dict(), device=dev), device=dev)
    frames = list(CA1MDataset(cfg))

    # ---- 1. stage-timed warm run
    stage = {"detector": 0.0}

    class TimedDetector:
        def __init__(self, inner):
            self.inner = inner

        def __call__(self, frame):
            t0 = time.perf_counter()
            out = self.inner(frame)
            stage["detector"] += time.perf_counter() - t0
            return out

        def __getattr__(self, name):
            return getattr(self.inner, name)

    def run_once(timed: bool):
        pipe = OnlinePipeline(cfg, TimedDetector(detector) if timed else detector, device=dev)
        t0 = time.perf_counter()
        pipe.run(frames, gap=GAP)
        sync(dev)
        return time.perf_counter() - t0, pipe

    run_once(False)  # warm
    total, pipe = run_once(True)
    stages = {
        "total_s": round(total, 3),
        "fps": round(len(frames) / total, 2),
        "detector_s": round(stage["detector"], 3),
        "geometry_s": round(pipe.timings.get("geometry", 0.0), 3),
        "fusion_s": round(pipe.timings.get("fusion", 0.0), 3),
    }
    stages["rest_s"] = round(total - stage["detector"] - stages["geometry_s"] - stages["fusion_s"], 3)

    # ---- 3. cProfile of a third run
    prof = cProfile.Profile()
    prof.enable()
    run_once(False)
    prof.disable()
    s = io.StringIO()
    pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(30)
    prof_text = s.getvalue()

    # ---- 2. the detector's forward: the reference's torch CuTR on the CPU
    # against the port's on --device, one identical frame
    blackbox.install_demo_stubs()
    with open(cfg_path) as f:
        ycfg = yaml.full_load(f)
    ycfg["data"]["datadir"] = seqdir + "/"
    from boxfusion.capture_stream import CA1MDataset as RefDS
    from boxfusion.cubify_transformer import make_cubify_transformer
    from boxfusion.preprocessor import Augmentor, Preprocessor

    sd = load_fixture_state_dict()
    tmodel = make_cubify_transformer(dimension=sd["backbone.0.patch_embed.proj.weight"].shape[0],
                                     depth_model=True).eval()
    tmodel.load_state_dict(sd, strict=True)
    packaged = Preprocessor().preprocess([Augmentor(("wide/image", "wide/depth")).package(next(iter(RefDS(ycfg))))])
    with torch.no_grad():
        tmodel(packaged)  # warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            tmodel(packaged)
        ref_ms = (time.perf_counter() - t0) / args.reps * 1e3

    detector(frames[0])  # warm
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        detector(frames[0])
    sync(dev)
    ours_ms = (time.perf_counter() - t0) / args.reps * 1e3

    out = {
        "protocol": {
            "scene": {"frames": N_FRAMES, "gap": GAP, "image_hw": list(HW)},
            "checkpoint": os.path.relpath(FIXTURE, REPO),
            "ours_device": str(dev),
        },
        "stages_warm_run": stages,
        "detector_forward_ab_ms": {
            "reference_torch_cpu": round(ref_ms, 1),
            f"ours_{dev.type}": round(ours_ms, 1),
            "ratio_ours_over_ref": round(ours_ms / ref_ms, 2),
            "note": f"identical fixture weights, same frame, float32, mean of {args.reps} warm calls each",
        },
    }
    print(json.dumps(out, indent=2))
    print("\n--- cProfile (cumulative, top 30) ---\n" + prof_text[:4000])
    out["cprofile_top"] = [ln.strip() for ln in prof_text.splitlines()
                           if "boxfusion_tpu_torch" in ln or "scipy" in ln][:15]
    path = args.out or os.path.join(root, "HOST_PROFILE.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
