"""Process-level contracts shared by the port's runtimes."""
