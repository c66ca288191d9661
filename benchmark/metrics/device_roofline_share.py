"""``device_roofline_share``: the least time of the profiled segment's work
over the card's busy time, in %.  The least time is each picture's coded
access unit read once and its output planes written once, at 3.35 TB/s:
counted from the stream alone, so it reads the same work whatever
implements it."""


def read(ctx):
    if not ctx["busy_s"] or not ctx["least_s"]:
        return None
    return ctx["least_s"] / ctx["busy_s"] * 100.0
