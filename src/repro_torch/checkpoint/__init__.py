"""Checkpoints: atomic save, retention, restore onto a device."""
