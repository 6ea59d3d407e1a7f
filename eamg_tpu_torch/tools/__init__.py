"""Offline tools of the port. So far only ``tools/medusa.py``: the Medusa
heads' loader and their acceptance probe."""
