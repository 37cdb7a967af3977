"""Device specs and the roofline floor."""
