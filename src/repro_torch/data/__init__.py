"""Synthetic inputs: the gate's moving-blob video streams and the language
models' token pipeline."""
