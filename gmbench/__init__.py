"""The benchmark of ``green_marl_tpu_torch`` on one NVIDIA H100.

``python -m gmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of the repository's ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
query kind, graph generator, metric or cell sits in a file of its own
under this package and is found by the name ``BENCHMARK.json`` gives it
(``spec.find``).  See ``README.md``.
"""
