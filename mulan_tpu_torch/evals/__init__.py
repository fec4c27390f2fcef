"""Evaluation: sparse VLB and ancestral sampling."""
