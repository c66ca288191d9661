"""``pack_ms``: ms a picture in the host pack, from the program's spans."""
from benchmark.metrics._spans import ms_per_picture


def read(ctx):
    return ms_per_picture(ctx, ('pack_native',))
