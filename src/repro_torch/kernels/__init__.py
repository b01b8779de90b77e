"""repro_torch.kernels — the hand-written CUDA kernels of the port
(``extrema``, ``fixpass``, ``lorenzo`` on the fix loop and transform;
``pack`` for ``entropy="device-pack"``; ``flash`` for the LM prefill's
attention), each beside its plain PyTorch version and a launch counter.
``_build`` compiles ``csrc/*.cu`` with nvcc at first use; importing this
package builds nothing."""
