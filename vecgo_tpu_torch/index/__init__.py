"""Segment indexes of the port (flat only, so far)."""
