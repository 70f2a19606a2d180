"""Host-side integer helpers."""
