"""``pack_queue_ms``: ms a picture that the pack worker's jobs waited in its
queue, from their submission to their start, from the program's spans."""
from benchmark.metrics._spans import ms_per_picture


def read(ctx):
    return ms_per_picture(ctx, ('pack_queue',))
