"""Host-side helpers: integer math, golden fixtures, host transfers,
checkpoints, timing, tracing and numerical checks."""
