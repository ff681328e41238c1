"""Fixtures for the port's tests and smoke run (not product code)."""
