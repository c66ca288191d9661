"""``h2d_bytes_per_picture``: bytes copied from the host to the card a
picture (the program's ``h2d_bytes`` counter)."""


def read(ctx):
    c = ctx["spans"].get("h2d_bytes")
    if c is None or "total" not in c or not ctx["pictures"]:
        return None
    return c["total"] / ctx["pictures"]
