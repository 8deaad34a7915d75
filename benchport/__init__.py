"""The benchmark of the PyTorch and CUDA port (`vecgo_tpu_torch`) on one card.

`python3 benchport/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once. Only `benchport/drive.py` imports the
program; everything else here (the generator, the plain reference, the
judge, the roofline counts, the trace reader and the per-layer readers) is
the yardstick and imports nothing of it.
"""
