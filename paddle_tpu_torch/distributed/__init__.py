"""Distributed layers of the port (single-device forms for now)."""
