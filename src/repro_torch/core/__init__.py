"""The PAS routing record of the port (own copy of what the engine logs)."""
