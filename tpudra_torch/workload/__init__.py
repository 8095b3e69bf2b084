"""Workload-side library on PyTorch: what runs inside a container that
consumed a claim, on a CUDA device.

- device:     resolve the torch device; CUDA unless the caller asks for the CPU
- envspec:    claim env → CUDA devices → process group (NCCL; gloo on the CPU)
              → named device mesh; the multi-process daemon client
- collectives: the five collectives' benchmarks and correctness checks
- model:      the flagship decoder train step, dense or Switch-MoE, on one
              device or sharded over a ("dp", "sp", "tp") mesh
- moe:        the top-1 routed expert FFN, expert-parallel over a group
- parallel:   the layout's process groups and autograd-aware collectives
- convert:    parameter trees to and from numpy, for carrying JAX weights over
- ce_kernel:  fused cross-entropy head (hand-written CUDA forward)
- opt_kernel: fused AdamW sweep with bf16 moments (Triton)
- attn_kernel: causal flash attention, forward and backward (hand-written CUDA)
"""
