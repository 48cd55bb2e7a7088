"""Batched forward passes over windowed data."""
