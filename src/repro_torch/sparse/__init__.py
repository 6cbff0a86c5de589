"""Sparse layer registry, serving formats and the condensed export."""
