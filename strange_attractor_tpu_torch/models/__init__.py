"""Attractor maps, color transforms and presets (PyTorch port)."""
