"""``il_build_ms``: ms an access unit in the SHVC inter-layer reference's
build on the pack worker (``pipeline.inter_layer_ref``: the spans
``il_color_map``, ``il_upsample`` and ``il_pad``); absent where the stream
has one layer."""
from benchmark.metrics._spans import ms_per_picture


def read(ctx):
    return ms_per_picture(ctx, ("il_color_map", "il_upsample", "il_pad"))
