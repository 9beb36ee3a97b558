"""Host-clock milliseconds a keyframe spends blocked on device-to-host reads
that steer the engine's control flow (``DevicePipeline.timings
["host_read_wait"]``, the wait of every ``utils/device.py:host_reads`` read
inside the keyframe step), over the unprofiled window."""


def read(obs):
    u = obs.unprofiled
    t = u.timings.get("host_read_wait")
    return t / u.keyframes * 1e3 if u.keyframes and t is not None else None
