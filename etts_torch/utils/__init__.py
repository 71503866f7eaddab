"""Config reading and the model factory."""
