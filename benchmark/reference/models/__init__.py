"""The reference's model steps, one module per model name of a
configuration: `constants(cfg, dtype, device)`, `initial(st, c)` and
`step(st, c, fx, fy)`."""
