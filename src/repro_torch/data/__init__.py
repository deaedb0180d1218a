"""Synthetic inputs of the gate: the moving-blob video streams."""
