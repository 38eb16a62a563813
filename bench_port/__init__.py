"""The benchmark of blazeseq_tpu_torch on one NVIDIA card.

`python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` generates the cell's corpus from the seed, drives one entry
of the port on it in a closed loop for the window, checks what the entry
produced against a plain reference, and prints one JSON line. Everything
that belongs to one configuration, traffic mix, route or metric lives in a
file of its own, found by the name that BENCHMARK.json gives (see harness).
Nothing here imports JAX or the JAX package.
"""
