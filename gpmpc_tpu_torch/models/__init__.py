"""GP, propagation and plant models."""
