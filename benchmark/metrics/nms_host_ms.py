"""Host-clock milliseconds a keyframe spends in the step's greedy NMS loop
(``timings["step.nms"]``, its blocking reads included), over the unprofiled
window."""


def read(obs):
    u = obs.unprofiled
    t = u.timings.get("step.nms")
    return t / u.keyframes * 1e3 if u.keyframes and t is not None else None
