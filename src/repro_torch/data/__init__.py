"""Synthetic tables of the port (numpy copies of ``repro.data``)."""
