"""Measurement scripts of the port; each runs with ``python -m``."""
