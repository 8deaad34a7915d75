"""Build and load of the hand-written CUDA kernels (sources in ../csrc)."""
