"""The plain reference of the benchmark: PyTorch only, nothing of the program."""
