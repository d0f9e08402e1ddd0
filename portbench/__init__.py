"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``
(``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``).  Everything that belongs to one configuration, traffic
mix or per-layer metric sits in a file of its own that the harness finds by
name: ``configs/<config>.json``, ``traffic/<mix>.json`` (read by the general
load generator ``kinds/<kind>.py`` that the mix names), ``workloads/<cell>.json``
(the limits of the cell's output check) and ``metrics/<metric>.py``."""
