"""Frozen operation and byte counts, and the peaks they are held to."""
