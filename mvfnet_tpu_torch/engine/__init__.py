"""Training and evaluation steps of the port."""
