"""The benchmark of ``hevc_tpu_torch`` on the card: ``python3 -m
benchmark.run --workload NAME --seed N --seconds S --trace 0|1``.

``BENCHMARK.json`` names the cells; each configuration, traffic mix, bank
and per-layer metric is a file of its own here (``configs/``,
``traffic/``, ``data/``, ``metrics/``).  ``program.py`` is the one module
that imports the program; ``reference/`` is the plain reference that
decides ``correct``; ``make_bank.py`` encodes the bank once, on the CPU.
Tests: ``python -m pytest benchmark/tests -q`` (the card's with
``-m cuda`` on a machine with one).
"""
