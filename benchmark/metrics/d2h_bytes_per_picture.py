"""``d2h_bytes_per_picture``: bytes copied from the card to the host a
picture (the program's ``d2h_bytes`` counter: the output fetch; absent
where the program has no such counter)."""


def read(ctx):
    c = ctx["spans"].get("d2h_bytes")
    if c is None or "total" not in c or not ctx["pictures"]:
        return None
    return c["total"] / ctx["pictures"]
