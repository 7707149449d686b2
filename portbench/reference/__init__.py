"""Plain PyTorch references the benchmark judges the port by; they import nothing of the program."""
