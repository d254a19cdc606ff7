"""Per-layer metric readers: one file per metric of BENCHMARK.json's
`per_layer`, found by the metric's name. Each declares UNIT, LAYER and
MOVES and defines `read(ctx)`, which returns the metric or None where
the traced run has nothing for it to read."""
