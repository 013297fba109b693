"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` (a configuration under
a traffic mix) on the card it is started on and prints one JSON line:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: ``configs/<config>.json`` (the model's
published sizes; its ``reference`` key names the family's plain reference
``references/<family>.py`` and its mapping onto the program
``ports/<family>.py``), ``traffic/<traffic>.json`` (the mix, whose
``kind`` names the driver ``kinds/<kind>.py``), ``limits/<workload>.json``
(the limits of the correctness check) and ``metrics/<metric>.py`` (one
reader per metric). A later cell, metric or model family is added by
adding files and entries; no file here needs an edit.

The yardstick lives here and nowhere in the program: the log generator
(``loggen.py``), the weights made from the seed (``weights.py``), the
FLOP and byte counts (``counts.py``, through each family's reference), the table of peaks
(``peaks.json``), the reduction of the profiler's trace (``trace.py``),
the plain references (``references/``) and the comparisons that decide
``correct`` (``checks.py``). The references import nothing of the
program, nor JAX, nor the JAX package.
"""
