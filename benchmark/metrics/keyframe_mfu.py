"""The model step's share of the card's bfloat16 peak, %: the FLOPs that
each keyframe's inputs need (the detector at the frame's pad bucket, and
the labeler's tower over its live rows up to the label budget, each counted
at the configuration's widths by its family's ``flops``, from
``harness/counts.py``) over the unprofiled window's seconds x 989 TFLOP/s."""
from benchmark.harness import peaks


def read(obs):
    u = obs.unprofiled
    if not u.keyframes or u.seconds <= 0:
        return None
    det, lab = obs.config["detector"], obs.config["labeler"]
    flops = u.keyframes * obs.families.detector.flops(det, u.pad, u.depth_ratio)
    flops += sum(obs.families.labeler.flops(lab, c) for c in u.crops if c > 0)
    return 100.0 * flops / (u.seconds * peaks.BF16_FLOPS)
