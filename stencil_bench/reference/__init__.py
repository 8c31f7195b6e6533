"""The plain reference of the benchmark: PyTorch alone, nothing of the program."""
