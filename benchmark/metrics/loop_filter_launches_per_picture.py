"""``loop_filter_launches_per_picture``: launches of the loop filter
kernels (deblocking and SAO) a picture, over the pack worker's frame
programs (the program's ``loop_filter_launches`` counter; absent where the
program has no such kernels, or off CUDA)."""


def read(ctx):
    c = ctx["spans"].get("loop_filter_launches")
    if c is None or "total" not in c or not ctx["pictures"]:
        return None
    return c["total"] / ctx["pictures"]
