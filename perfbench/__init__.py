"""The benchmark of the PyTorch/CUDA port (``tpudra_torch``): see run.py."""
