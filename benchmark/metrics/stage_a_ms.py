"""``stage_a_ms``: ms a picture in stage A on the host (native C++ and the
Python syntax layer), from the program's spans."""
from benchmark.metrics._spans import ms_per_picture


def read(ctx):
    return ms_per_picture(ctx, ('stage_a_native', 'stage_a_python'))
