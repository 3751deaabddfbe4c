"""Trajectory NLP solver and Riccati KKT sweep."""
