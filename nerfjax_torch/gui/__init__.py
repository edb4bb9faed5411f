"""Viewers of the port."""
