"""Incubating models of the port (:mod:`.models`)."""
