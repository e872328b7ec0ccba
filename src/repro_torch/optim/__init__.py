"""Optimizer, learning-rate schedules and gradient compression."""
