"""Model config, parameters and the transformer forward."""
