"""Framework pieces of the port: the training step's random state
(:mod:`.random`)."""
