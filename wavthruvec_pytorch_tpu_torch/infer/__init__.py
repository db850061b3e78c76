"""Inference front ends."""
