"""``pack_worker_busy_share``: the pack worker's busy time (its jobs'
spans) over the wall seconds of the same span window, in %."""

WALL = "_wall"  # the program's reserved name for its window's wall seconds


def read(ctx):
    spans = ctx["spans"]
    wall = spans.get(WALL, {}).get("total_s")
    if "pack_worker" not in spans or not wall:
        return None
    return spans["pack_worker"]["total_s"] / wall * 100.0
