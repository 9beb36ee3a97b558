"""Build a trained CuTR-192 checkpoint on the black-box parity scene.

Port of ``tools/build_parity_fixture.py``.  Overfits CuTR-192 with the port's
trainer (``boxfusion_tpu_torch.train``, ``--data-root`` mode) on the parity
scene (``blackbox.write_scene``: 36 frames at 192x256, 6 boxes, seed 0;
``write_config`` at gap 7) in the staged schedule of the committed fixture's
record: 300 steps at lr 1e-3, 1000 at 5e-4, 400 at 2e-4, batch 2, gap 1,
depth ratio 1, each stage resuming from the last.  Exports
``{"model": state_dict}`` in float32, the reference's checkpoint format
(demo.py:441).

The default ``--out`` is ``tests/fixtures/cutr_trained_192.pth``, the JAX
tool's name.  It is never ``tests/fixtures/cutr_trained_192_f16.pth``, the
committed file the tests load: a new build has other weight values.

    python -m boxfusion_tpu_torch.tools.build_parity_fixture
    python -m boxfusion_tpu_torch.tools.build_parity_fixture --device cpu --out /tmp/fixture.pth
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from boxfusion_tpu_torch.tools import blackbox
from boxfusion_tpu_torch.tools.common import REPO
from boxfusion_tpu_torch.utils.device import resolve_device

STAGES = ((300, 1e-3), (1000, 5e-4), (400, 2e-4))
DIM = 192
BATCH = 2
FIXTURE = os.path.join(REPO, "tests", "fixtures", "cutr_trained_192.pth")
COMMITTED = os.path.join(REPO, "tests", "fixtures", "cutr_trained_192_f16.pth")


def run(device=None, workdir=None, out=FIXTURE, stages=STAGES, keep=False) -> dict:
    """Write the scene, train ``stages`` ((steps, learning rate) pairs) and
    export to ``out``, which may not be the committed fixture; returns the
    seconds of each stage and in all."""
    dev = resolve_device(device)
    if os.path.abspath(out) == os.path.abspath(COMMITTED):
        raise ValueError(f"refusing to overwrite {COMMITTED}, the fixture the tests load")
    workdir = os.path.join(tempfile.gettempdir(), "parity_fixture") if workdir is None else workdir
    if not keep and os.path.isdir(workdir):
        shutil.rmtree(workdir)
    os.makedirs(workdir, exist_ok=True)
    seqdir = os.path.join(workdir, blackbox.SEQ)
    if not os.path.isdir(seqdir):
        blackbox.write_scene(seqdir, n_frames=36, image_hw=(192, 256))
    cfg_path = blackbox.write_config(os.path.join(workdir, "train.yaml"), datadir=seqdir,
                                     output_dir=os.path.join(workdir, "unused"), gap=7, image_hw=(192, 256))
    stage_s = []

    def log(steps, lr, seconds):
        stage_s.append(seconds)
        print(f"[fixture] stage {steps}@{lr}: {seconds:.1f} s ({steps / seconds:.2f} steps/s)",
              file=sys.stderr, flush=True)

    ckpt = blackbox.train_stages(seqdir, cfg_path, os.path.join(workdir, "train_ckpt"), stages,
                                 dim=DIM, batch=BATCH, seed=0, device=dev, log=log)
    blackbox.export_checkpoint(ckpt, out)
    steps = sum(s for s, _ in stages)
    print(f"[fixture] wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, {steps} steps "
          f"in {sum(stage_s):.1f} s on {dev})")
    return dict(out=out, steps=steps, stage_seconds=stage_s, seconds=sum(stage_s))


def main(argv=None, stages=STAGES) -> int:
    """``stages``: (steps, learning rate) pairs, the schedule to train."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "parity_fixture"))
    ap.add_argument("--out", default=FIXTURE)
    ap.add_argument("--keep", action="store_true", help="reuse an existing workdir (its scene)")
    args = ap.parse_args(argv)
    run(args.device, args.workdir, args.out, stages, args.keep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
