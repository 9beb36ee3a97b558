"""Host-clock milliseconds a keyframe spends in the step's fusion stage
(``timings["step.fuse"]``: the eligible slots, the PST search and the IoU
refresh of the moved boxes), over the unprofiled window."""


def read(obs):
    u = obs.unprofiled
    t = u.timings.get("step.fuse")
    return t / u.keyframes * 1e3 if u.keyframes and t is not None else None
