"""Evaluation subpackage."""
