"""Model-parallel layers; only the unsharded cross-entropy is ported."""
