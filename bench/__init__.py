"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line.  Everything a cell is made of is found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
the driver the mix names (``drivers/<driver>.py``), the model family's
plain reference and weight maker (``references/<family>.py``) and its
mapping onto the port's config (``ports/<family>.py``), the correctness
limits of the cell (``limits/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``).  The yardstick (traffic generation, peaks,
operation and byte counts, trace reduction, the comparison that decides
``correct``) lives here and not in the program.
"""
