"""Plain references: NumPy or PyTorch alone, nothing of the program."""
