"""Frozen operation and byte counts of the measured work, with the published peaks."""
