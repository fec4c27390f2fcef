"""Metric writers and image grids."""
