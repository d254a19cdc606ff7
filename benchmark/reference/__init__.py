"""Plain PyTorch and numpy reference of the benchmark's configurations.
It imports neither the program under test nor JAX."""
