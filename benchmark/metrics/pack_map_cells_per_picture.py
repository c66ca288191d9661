"""``pack_map_cells_per_picture``: cells of the wavefront level map that the
host pack's native records pass keeps, an access unit handed in (the
program's ``pack_map_cells`` counter; 0 for a picture with no intra record;
absent where the program has no such counter)."""


def read(ctx):
    c = ctx["spans"].get("pack_map_cells")
    if c is None or "total" not in c or not ctx["pictures"]:
        return None
    return c["total"] / ctx["pictures"]
