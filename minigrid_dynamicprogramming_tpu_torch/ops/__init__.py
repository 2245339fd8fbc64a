"""Batched grid builders and step helpers."""
