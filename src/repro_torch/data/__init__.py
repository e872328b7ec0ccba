"""Synthetic LM data: the seeded token stream and its batches."""
