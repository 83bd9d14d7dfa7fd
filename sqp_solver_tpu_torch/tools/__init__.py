"""Measurement scripts that run on the card (see each module)."""
