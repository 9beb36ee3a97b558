"""Host-clock milliseconds a keyframe spends packing its transfer buffer and
handing it to the device (``FusedDevicePipeline.timings["upload"]``: the pack,
the pin and the copy's enqueue), over the unprofiled window."""


def read(obs):
    u = obs.unprofiled
    t = u.timings.get("upload")
    return t / u.keyframes * 1e3 if u.keyframes and t is not None else None
