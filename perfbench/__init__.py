"""The benchmark of the PyTorch/CUDA port (nfdpm_tpu_torch) on the H100.

Run a cell as `python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout; BENCHMARK.json
lists the cells, their metrics and bounds.
"""
