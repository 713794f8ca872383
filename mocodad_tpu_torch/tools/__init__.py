"""Scripts of the port that run on the card (the counterparts of the JAX
repository's `tools/`)."""
