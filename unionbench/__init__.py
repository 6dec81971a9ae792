"""The benchmark of the PyTorch and CUDA port (``repro_torch``): sampling
over a union of joins on TPC-H-lite data, served to clients.  Run one cell
once with ``python3 unionbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the checkout's root
lists the cells."""
