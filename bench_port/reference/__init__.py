"""Plain PyTorch float32 versions of what the benchmark's cells run; they
import nothing of the program."""
