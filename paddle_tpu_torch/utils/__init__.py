"""Utilities of the port shared across its subpackages."""
