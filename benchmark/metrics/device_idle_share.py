"""Share of the profiled keyframes' span in which the device ran nothing
(1 - the union of its kernel, copy and fill intervals over the span), %."""


def read(obs):
    p = obs.profiled
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
