"""``il_motion_ms``: ms an access unit in the SHVC inter-layer motion
mapping on the caller's thread (span ``il_motion`` around
``upscale_motion_field`` in ``decoder/core.py _start_el_picture``); absent
where the stream has one layer, and in a program without the span."""
from benchmark.metrics._spans import ms_per_picture


def read(ctx):
    return ms_per_picture(ctx, ("il_motion",))
