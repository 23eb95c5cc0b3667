"""The IANUS simulator's pieces the port has: the energy model."""
