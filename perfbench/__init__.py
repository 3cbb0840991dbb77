"""The benchmark of jpeg_decoder_tpu_torch on one NVIDIA H100: the cells of
BENCHMARK.json (at the repository's root), run one at a time by
`python3 -m perfbench` (harness.py). It drives the PyTorch and CUDA package
only, and judges its outputs by the plain reference in reference.py."""
