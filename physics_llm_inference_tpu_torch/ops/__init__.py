"""Plain tensor ops: norms, RoPE, grouped attention, FFNs, sampling."""
