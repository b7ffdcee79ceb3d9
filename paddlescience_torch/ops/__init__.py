"""Hand-written CUDA kernels and their plain PyTorch versions. Importing
this package builds nothing: kernels compile at first launch
(``ops/cuda_build.py``)."""
