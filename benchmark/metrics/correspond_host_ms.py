"""Host-clock milliseconds a keyframe spends in the step's correspondence
stage (``timings["step.correspond"]``: the 2D projection, the read of
whether a new box survived, the correspondence loop, the compaction and the
stale drop), over the unprofiled window."""


def read(obs):
    u = obs.unprofiled
    t = u.timings.get("step.correspond")
    return t / u.keyframes * 1e3 if u.keyframes and t is not None else None
