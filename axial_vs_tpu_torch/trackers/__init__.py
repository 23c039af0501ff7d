"""Trackers that carry instance ids across windows (host numpy)."""
