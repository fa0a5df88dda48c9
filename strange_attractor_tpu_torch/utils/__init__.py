"""Host utilities: image export."""
