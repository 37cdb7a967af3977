"""Device specs and the roofline model."""
