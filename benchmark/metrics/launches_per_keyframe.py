"""Kernel launches per keyframe, counted from the device's kernel events
over the profiled keyframes."""


def read(obs):
    p = obs.profiled
    if p is None or not p.keyframes:
        return None
    return sum(1 for e in p.events if e.get("cat") == "kernel") / p.keyframes
