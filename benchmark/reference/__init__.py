"""The plain reference that the benchmark's comparison holds the program
to: `carve.py`.  Plain PyTorch and NumPy; nothing of the program."""
