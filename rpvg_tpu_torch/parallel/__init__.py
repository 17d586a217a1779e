"""Multi-process entry points of the port."""
