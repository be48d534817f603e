"""Measurement scripts of the port; each runs on the card."""
