"""Work counts of the kernels and of the whole step: one file per kernel,
found by name."""
