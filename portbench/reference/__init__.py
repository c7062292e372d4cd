"""The plain reference of the benchmark's cells (``onoff``): plain PyTorch,
nothing of the program."""
