"""``device_idle_share``: the share of the profiled slice's wall time in
which no kernel, copy or set ran on the card, in %."""


def read(ctx):
    if not ctx["busy_s"] or not ctx["window_s"]:
        return None
    return (1.0 - ctx["busy_s"] / ctx["window_s"]) * 100.0
