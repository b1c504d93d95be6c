"""The plain reference: float32 PyTorch and NumPy, nothing of the system
under test."""
