"""Lanes sharded over several devices (mesh.py)."""
