"""Workload-side coordination client: the membership half
(client.py)."""
