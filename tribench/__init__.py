"""tribench: the benchmark of the PyTorch / H100 port (``repro_torch``).

One command runs one cell once::

    python3 tribench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (an entry of ``workloads`` in the repository's ``BENCHMARK.json``)
names a configuration and a traffic mix.  Everything that belongs to one
configuration, mix, per-layer metric, analysis or data set is a file of
its own under this folder, found by its name (:mod:`tribench.registry`).
Nothing here imports JAX or the JAX package ``repro``; the plain reference
(:mod:`tribench.reference`) imports nothing of ``repro_torch`` either.
"""
