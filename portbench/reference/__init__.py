"""The plain reference of the benchmark: RefineDet, its losses, its
augmentation, its post-processing and its int8 quantization in plain
PyTorch float32. It imports nothing of the port and takes nothing the
port made."""
