"""Batch-last (lane-major) stepping and rollouts."""
