"""Control-plane plumbing shared by the port's serving layers: the
in-process event bus (bus.py)."""
