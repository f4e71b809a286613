"""Registered architecture configurations."""
