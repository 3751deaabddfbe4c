"""Receding-horizon controller and costs."""
