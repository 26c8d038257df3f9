"""The plain references that decide `correct`: NumPy and plain PyTorch
only. Nothing here imports the system under test; each works out again,
from the benchmark's own inputs or from the program's recorded state, what
the program derived."""
