"""Per-layer metric readers: ``<metric>.py`` holds ``read(ctx)``, which
returns the metric from the run's spans and device trace, or None where it
finds nothing to read (the run then leaves the metric out).

``ctx``: ``spans`` (the program's span accumulators, name -> ``calls``,
``total_s``), ``pictures`` (the access units handed in while they ran),
``busy_s`` and ``window_s`` (device-busy seconds and wall seconds of the
profiled slice, None without one) and ``least_s`` (the least time the
slice's work takes at the card's memory bandwidth).
"""
