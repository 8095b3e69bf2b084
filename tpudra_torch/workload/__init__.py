"""Workload-side library on PyTorch: what runs inside a container that
consumed a claim, on a CUDA device.

- device:     resolve the torch device; CUDA unless the caller asks for the CPU
- envspec:    claim env parsing (the pure parts of ``tpudra.workload.envspec``)
- model:      the flagship decoder train step (single device)
- convert:    parameter trees to and from numpy, for carrying JAX weights over
- ce_kernel:  fused cross-entropy head (hand-written CUDA forward)
- opt_kernel: fused AdamW sweep with bf16 moments (Triton)
- attn_kernel: causal flash attention, forward and backward (hand-written CUDA)
"""
