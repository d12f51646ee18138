"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload yi-6b.decode --seed 7 \\
        --seconds 45 --trace 0

and prints one JSON line. Everything that belongs to one configuration,
traffic mix or metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``mixes/<mix>.json``, ``metrics/<metric>.py``.
The yardstick (traffic, peaks, operation and byte counts, the plain
reference in ``reference/`` and the comparison that decides ``correct``)
lives here, apart from the program it measures.
"""
