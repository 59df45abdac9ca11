"""Training substrate: AdamW, gradient compression, checkpoints, fault tolerance."""
