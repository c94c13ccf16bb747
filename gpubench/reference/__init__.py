"""The plain reference of the benchmark: NumPy and plain PyTorch, with no
import of the program or of JAX."""
