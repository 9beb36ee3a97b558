"""Device milliseconds a keyframe's label stage launched (kernels, copies and
fills charged to the ``bench.label`` span by correlation id), over the
profiled keyframes."""


def read(obs):
    p = obs.profiled
    if p is None or not p.spans_found.get("bench.label") or not p.keyframes:
        return None
    return p.span_device_s["bench.label"] / p.keyframes * 1e3
