"""Launchers and mesh descriptors."""
