"""Optimizers and schedules of the port."""
