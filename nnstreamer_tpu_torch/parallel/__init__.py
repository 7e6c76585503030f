"""Parallel attention layers (reduced: only the unsharded reference so far)."""
