"""Device-to-host reads that steer the engine's control flow, per keyframe
(``utils/device.py:host_reads``, over the unprofiled window): each one waits
for everything queued before it."""


def read(obs):
    u = obs.unprofiled
    return u.host_reads / u.keyframes if u.keyframes else None
