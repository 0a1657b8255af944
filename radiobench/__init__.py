"""radiobench: the benchmark of grtpu_torch on one NVIDIA GPU.

Run one cell once from the root of a checkout:

    python3 -m radiobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
