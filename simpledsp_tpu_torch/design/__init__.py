"""Host-side float64 filter design (NumPy)."""
