"""Synthetic data subpackage."""
