"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything a cell needs is found by name: its configuration file,
its traffic file (``traffic/<name>.json``) and the driver of that
traffic's kind (``traffic/<kind>.py``), its limits (``checks/<cell>.json``)
and one reader a metric (``metrics/<metric>.py``).  ``README.md`` says
how to add each of them as new files.
"""
