"""Device milliseconds a keyframe's detect stage launched: kernels, copies and
fills charged by correlation id to the program's own ``boxfusion.detect``
span (``utils/profiling.span``), among its sibling spans detect, label and
step, over the profiled keyframes."""
from benchmark.harness import trace

SPANS = ("boxfusion.detect", "boxfusion.label", "boxfusion.step")


def read(obs):
    p = obs.profiled
    if p is None or not p.keyframes or not any(
            e.get("cat") == "user_annotation" and e.get("name") == "boxfusion.detect" for e in p.events):
        return None
    return trace.device_s_by_span(p.events, SPANS)["boxfusion.detect"] / p.keyframes * 1e3
