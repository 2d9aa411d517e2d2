"""Serving fleet: the port carries only :mod:`.selection`, the hashing the
mesh dispatcher's lane law uses.  The fleet router, replica registry,
routing policies and failover come in a later slice (ROADMAP Queue 1)."""
