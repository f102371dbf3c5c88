"""Pairwise aligner and k-way engine."""
