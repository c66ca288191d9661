"""``fetch_ms``: ms a picture in the fetch of output planes to the host, from
the program's spans."""
from benchmark.metrics._spans import ms_per_picture


def read(ctx):
    return ms_per_picture(ctx, ('fetch',))
