"""Codes: the edge-list container, the npz store and the host sampler."""
