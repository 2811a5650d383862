"""The benchmark of thermal3d_torch on one NVIDIA H100 (see BENCHMARK.json).

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell from the root of a checkout. Everything that belongs to one
configuration, traffic mix, request path, per-layer metric or cell's limits
sits in a file of its own under this folder and is found by its name.
"""
