"""PyTorch/CUDA port of the repro package (see ROADMAP.md): one H100,
hand-written Hopper kernels for the bq codec."""
