"""repro_torch.kernels — the hand-written CUDA kernels of the main path
(``extrema``, ``fixpass``, ``lorenzo``), each beside its plain PyTorch
version and a launch counter. ``_build`` compiles ``csrc/*.cu`` with
nvcc at first use; importing this package builds nothing."""
