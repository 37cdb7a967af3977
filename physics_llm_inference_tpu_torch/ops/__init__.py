"""Plain tensor ops: norms, RoPE, grouped attention, sampling."""
