"""The benchmark of the PyTorch and CUDA port (``megaportraits_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything a cell needs is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); ``systems/<system>.py`` drives the program;
``metrics/<metric>.py`` reads one per-layer metric from the trace;
``flops/`` counts operations and bytes from shapes; ``reference/`` is the
plain float32 model that decides ``correct``.
"""
