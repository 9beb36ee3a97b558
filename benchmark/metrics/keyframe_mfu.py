"""The model step's share of the card's bfloat16 peak, %: the FLOPs that
each keyframe's inputs need (CuTR at the frame's pad bucket, and the CLIP
tower over its live rows up to the label budget, counted at the
configuration's widths by ``harness/counts.py``) over the unprofiled
window's seconds x 989 TFLOP/s."""
from benchmark.harness import counts, peaks


def read(obs):
    u = obs.unprofiled
    if not u.keyframes or u.seconds <= 0:
        return None
    det, lab = obs.config["detector"], obs.config["labeler"]
    tower = {k: lab[k] for k in ("image_size", "patch", "width", "layers", "embed_dim")}
    flops = u.keyframes * counts.cutr_flops(u.pad, u.depth_ratio, embed_dim=det["embed_dim"])
    flops += sum(counts.tower_flops(c, **tower) for c in u.crops if c > 0)
    return 100.0 * flops / (u.seconds * peaks.BF16_FLOPS)
