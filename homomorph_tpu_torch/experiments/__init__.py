"""Experiments of the port (counterparts of the repo's ``experiments/``)."""
