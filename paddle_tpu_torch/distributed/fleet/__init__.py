"""Single-device forms of the fleet layers."""
