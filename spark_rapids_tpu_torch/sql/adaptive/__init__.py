"""Adaptive execution (counterpart of the JAX package's ``sql/adaptive``):
only the shuffle statistics of ``stats.py`` are ported so far (ROADMAP
A.10 holds the rest)."""
