"""Butterfly math and the sandwich layer (paper §3)."""
