"""Configurations of the port (the store fields of `repro.configs`)."""
