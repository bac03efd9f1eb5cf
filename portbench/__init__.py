"""The benchmark of bcm3_tpu_torch, the PyTorch and CUDA port (portbench/README.md)."""
