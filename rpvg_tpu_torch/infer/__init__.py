"""Inference layer of the port."""
