"""Control-plane plumbing shared by the port's serving layers: the
in-process event bus and its cross-process tap (bus.py), and the
deterministic fault plan with its process crashpoints (faults.py)."""
