"""Shared arithmetic of the span readers: the program's spans, summed over
the names given, in ms per access unit handed in; None where the window
recorded none of them."""


def ms_per_picture(ctx, names):
    spans = ctx["spans"]
    hit = [spans[n]["total_s"] for n in names if n in spans]
    if not hit or not ctx["pictures"]:
        return None
    return sum(hit) / ctx["pictures"] * 1e3
