"""Glow and its Gaussian prior."""
