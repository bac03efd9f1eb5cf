"""Plain PyTorch and numpy references of what the benchmark runs. They
import neither JAX nor bcm3_tpu nor bcm3_tpu_torch."""
