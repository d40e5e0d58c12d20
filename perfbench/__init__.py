"""The benchmark of the PyTorch and CUDA package ``skypilot_tpu_torch``.

Run one cell with ``python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; see README.md.
"""
