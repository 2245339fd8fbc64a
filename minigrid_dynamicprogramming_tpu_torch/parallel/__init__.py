"""Batch-last (lane-major) stepping and rollouts, and the process groups
that split an env batch over devices."""
