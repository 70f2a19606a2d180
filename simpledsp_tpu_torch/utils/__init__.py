"""Host-side helpers: integer math, golden fixtures, host transfers,
checkpoints, timing and numerical checks."""
