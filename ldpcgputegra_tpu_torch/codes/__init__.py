"""LDPC code definitions, schedules and the registry (NumPy)."""
