"""Process exit codes the serving runtime reports to its supervisor.

The same values as the JAX package's exit-code taxonomy, kept here so
the port imports nothing from that package.
"""
from __future__ import annotations

__all__ = ["EXIT_WATCHDOG", "EXIT_DRAIN"]

#: the serve hang watchdog force-exited a wedged process (BSD EX_SOFTWARE)
EXIT_WATCHDOG = 70
#: 128+SIGTERM: asked to stop, stopped cleanly after a graceful drain
EXIT_DRAIN = 143
