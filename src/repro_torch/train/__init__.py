"""Training: AdamW, int8 error-feedback gradient compression, the trainer."""
