"""Offline pruning and packing of conv filters."""
