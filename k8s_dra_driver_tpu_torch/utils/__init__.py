"""Framework-level helpers shared by the port's layers."""
