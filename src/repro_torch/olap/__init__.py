"""Columnar datasets, their device mirror, and the OLAP executor."""
