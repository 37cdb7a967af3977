"""KV cache and generation loops."""
