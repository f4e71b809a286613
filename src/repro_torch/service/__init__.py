"""The staged request pipeline."""
