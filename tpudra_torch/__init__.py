"""PyTorch/CUDA port of the tpudra workload library.

``tpudra_torch.workload`` mirrors ``tpudra.workload`` module by module, for
NVIDIA Hopper GPUs.  The port imports nothing of ``tpudra`` or of JAX: the
JAX package stays the reference, and the parity tests
(``tests/test_torch_*.py``) hold the two against each other.
"""
