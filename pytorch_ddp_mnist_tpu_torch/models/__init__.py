"""Models: the reference MLP."""
