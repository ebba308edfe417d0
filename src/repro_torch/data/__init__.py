"""Synthetic temporal-graph event streams."""
