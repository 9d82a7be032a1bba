"""The plain reference: PyTorch float32, TF32 off, importing nothing of the program."""
