"""Core of the port: device resolution and the flag registry."""
