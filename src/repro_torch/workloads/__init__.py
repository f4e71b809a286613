"""Workloads: schemas, synthetic data and query streams."""
