"""Device milliseconds a keyframe's attention-pool head launched: kernels,
copies and fills charged by correlation id to the program's own
``boxfusion.label.pool`` span (the SigLIP tower's head, inside
``boxfusion.label``), over the profiled keyframes.  A program without the
span reads nothing."""
from benchmark.harness import trace

SPAN = "boxfusion.label.pool"


def read(obs):
    p = obs.profiled
    if p is None or not p.keyframes or not any(
            e.get("cat") == "user_annotation" and e.get("name") == SPAN for e in p.events):
        return None
    return trace.device_s_by_span(p.events, (SPAN,))[SPAN] / p.keyframes * 1e3
