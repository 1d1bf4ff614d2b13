"""Plain float32 PyTorch reference of the benchmark's configurations; it
imports nothing of the program under test."""
