"""The configurations' plain references: PyTorch and numpy only."""
