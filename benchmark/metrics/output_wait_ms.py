"""``output_wait_ms``: ms a picture that the caller waited on the pack
worker before a picture's planes could be fetched, from the program's
spans."""
from benchmark.metrics._spans import ms_per_picture


def read(ctx):
    return ms_per_picture(ctx, ('output_wait',))
