"""Benchmark of the PyTorch/CUDA port (``bikg_graph_explainability_public_tpu_torch``).

``python -m bench_port.run --workload <config>.<mix> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
and prints one JSON line.  Everything a cell is made of is found by name:
``configs/<config>.json`` (graph and model sizes), ``traffic/<mix>.json``
(the queries a run sends), ``metrics/<metric>.py`` (one reader a metric),
``drivers/<entry>.py`` (how an entry of the program is driven),
``families/<family>.py`` (how a model family is built in the program) with
its plain reference ``reference/<family>.py``, and ``checks/<cell>.json``
(the limits of the comparison that decides ``correct``).
"""
