"""Measure the near-threshold selection band of the deterministic parity regime.

Port of ``tools/diagnose_parity_band.py``.  Runs the original BoxFusion's
own torch CuTR (on the CPU) and the port's CuTR (on ``--device``) on the
parity scene's keyframes with the committed trained fixture, matches
detections across the stacks by 2D IoU (greedy, IoU >= 0.7), and reports:

  * the |score_ours - score_ref| distribution over matched detections (the
    measured activation-noise band);
  * the detections whose score lies within that band of the 0.03 threshold
    (the flip-eligible set);
  * the detections that crossed the threshold in one stack only (the
    realised flips).

Writes the JSON to ``--out`` (default ``<workdir>/PARITY_BAND.json``).
Needs the original BoxFusion at ``blackbox.REF``; without it the tool prints
one line naming the missing path and exits with status 2 before any work.

    python -m boxfusion_tpu_torch.tools.diagnose_parity_band
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from boxfusion_tpu_torch.tools import blackbox
from boxfusion_tpu_torch.tools.common import REPO
from boxfusion_tpu_torch.utils.device import resolve_device

FIXTURE = os.path.join(REPO, "tests", "fixtures", "cutr_trained_192_f16.pth")
THRESH = 0.03
GAP = 7


def iou_xyxy(a, b):
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    ar_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ar_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (ar_a[:, None] + ar_b[None] - inter + 1e-9)


def load_fixture_state_dict(path: str = FIXTURE) -> dict:
    """The fixture's state dict in float32."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)["model"]
    return {k: v.float() for k, v in sd.items()}


def run_reference_detector(cfg_path, seqdir, kf_idx):
    """The reference's own dataset -> Augmentor -> Preprocessor -> CuTR
    (demo.py:129-136) on the keyframes; per frame {scores, boxes (xyxy)}."""
    blackbox.install_demo_stubs()
    import torch
    import yaml

    with open(cfg_path) as f:
        cfg = yaml.full_load(f)
    cfg["data"]["datadir"] = seqdir if seqdir.endswith("/") else seqdir + "/"

    from boxfusion.capture_stream import CA1MDataset as RefDS
    from boxfusion.cubify_transformer import make_cubify_transformer
    from boxfusion.preprocessor import Augmentor, Preprocessor

    sd = load_fixture_state_dict()
    dim = sd["backbone.0.patch_embed.proj.weight"].shape[0]
    model = make_cubify_transformer(dimension=dim, depth_model=True).eval()
    model.load_state_dict(sd, strict=True)
    augmentor = Augmentor(("wide/image", "wide/depth"))
    pre = Preprocessor()
    out, want = [], set(kf_idx)
    for i, sample in enumerate(RefDS(cfg)):
        if i not in want:
            continue
        packaged = pre.preprocess([augmentor.package(sample)])
        with torch.no_grad():
            res = model(packaged)[0]
        out.append({"scores": res.scores.numpy().astype(np.float64),
                    "boxes": res.pred_boxes.numpy().astype(np.float64)})
    return out


def band_report(ours, ref) -> dict:
    """Match each keyframe's detections by 2D IoU (greedy, >= 0.7) and
    measure the score band and the threshold flips."""
    deltas, eligible, flips, total = [], 0, 0, 0
    for o, r in zip(ours, ref):
        if len(r["scores"]) == 0 or len(o["scores"]) == 0:
            continue
        mm = iou_xyxy(o["boxes"], r["boxes"])
        pairs = []
        while True:
            i, j = np.unravel_index(np.argmax(mm), mm.shape)
            if mm[i, j] < 0.7:
                break
            pairs.append((i, j))
            mm[i, :] = -1
            mm[:, j] = -1
        for i, j in pairs:
            deltas.append(abs(o["scores"][i] - r["scores"][j]))
            total += 1
        band = np.percentile(deltas, 95) if deltas else 0.0
        for i, j in pairs:
            so, sr = o["scores"][i], r["scores"][j]
            if min(abs(so - THRESH), abs(sr - THRESH)) <= band:
                eligible += 1
            if (so >= THRESH) != (sr >= THRESH):
                flips += 1
    deltas = np.asarray(deltas)
    return {
        "matched_detections": int(total),
        "score_abs_delta": {"median": float(np.median(deltas)), "p90": float(np.percentile(deltas, 90)),
                            "p95": float(np.percentile(deltas, 95)), "max": float(np.max(deltas))},
        "threshold": THRESH,
        "flip_eligible_within_p95_band": int(eligible),
        "realized_threshold_flips": int(flips),
        "verdict": (
            "detector-level selection is identical on this scene (no threshold flip); remaining "
            "world-set differences come from downstream of the detector" if flips == 0 else
            "the selection-boundary band is real: every realised flip lies inside the measured "
            "score-noise band around the threshold" if flips <= eligible else
            "flips exceed the band: look at the conversion path"
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the port's CuTR runs (the reference: the CPU)")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "blackbox_parity"))
    ap.add_argument("--out", default=None, help="default: <workdir>/PARITY_BAND.json")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    missing = blackbox.reference_missing("diagnose_parity_band")
    if missing:
        print(missing, file=sys.stderr)
        return 2

    from boxfusion_tpu_torch.data.readers import CA1MDataset
    from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector
    from boxfusion_tpu_torch.utils.config import load_config

    root = args.workdir
    seqdir = os.path.join(root, blackbox.SEQ)
    if not os.path.isdir(seqdir):
        os.makedirs(root, exist_ok=True)
        blackbox.write_scene(seqdir, n_frames=36, image_hw=(192, 256))
    cfg_path = blackbox.write_config(os.path.join(root, "diag.yaml"), datadir=seqdir,
                                     output_dir=os.path.join(root, "diag_out"), gap=GAP, image_hw=(192, 256))

    det = CuTRDetector(load_torch_state_dict(load_fixture_state_dict(), device=dev), device=dev)
    frames = list(CA1MDataset(load_config(cfg_path)))
    kf_idx = [i for i in range(len(frames)) if i % GAP == 0 or i == len(frames) - 1]
    ours = []
    for i in kf_idx:
        o = det(frames[i])
        ours.append({"scores": np.asarray(o["scores"], np.float64), "boxes": np.asarray(o["pred_boxes"], np.float64)})
    ref = run_reference_detector(cfg_path, seqdir, kf_idx)

    out = band_report(ours, ref)
    print(json.dumps(out, indent=2))
    path = args.out or os.path.join(root, "PARITY_BAND.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
