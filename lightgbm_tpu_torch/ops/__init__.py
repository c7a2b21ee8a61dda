"""Device-side prediction ops (routing reference, exact accumulation)."""
