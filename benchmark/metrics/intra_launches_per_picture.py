"""``intra_launches_per_picture``: launches of the intra wavefront kernel a
picture, one a live chunk, over the pack worker's frame programs (the
program's ``intra_launches`` counter; absent where the program has no such
counter, or off CUDA)."""


def read(ctx):
    c = ctx["spans"].get("intra_launches")
    if c is None or "total" not in c or not ctx["pictures"]:
        return None
    return c["total"] / ctx["pictures"]
