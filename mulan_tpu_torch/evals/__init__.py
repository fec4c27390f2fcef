"""Evaluation: sparse and dense VLB, checkpoint evaluation and ancestral
sampling."""
