"""Execution engines (the pull engine) and method resolution."""
