"""``device_allocs_per_picture``: ``cudaMalloc`` calls of the caching
allocator a picture, over the pack worker's jobs (the program's
``device_allocs`` counter; absent off CUDA)."""


def read(ctx):
    c = ctx["spans"].get("device_allocs")
    if c is None or "total" not in c or not ctx["pictures"]:
        return None
    return c["total"] / ctx["pictures"]
