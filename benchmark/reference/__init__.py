"""The plain float32 reference: imports torch and numpy only."""
