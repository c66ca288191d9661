"""``residual_launches_per_picture``: launches of the residual-stage kernel
a picture, over the pack worker's frame programs (the program's
``residual_launches`` counter; absent where the program has no such
kernel, or off CUDA)."""


def read(ctx):
    c = ctx["spans"].get("residual_launches")
    if c is None or "total" not in c or not ctx["pictures"]:
        return None
    return c["total"] / ctx["pictures"]
