"""Fault injection."""
