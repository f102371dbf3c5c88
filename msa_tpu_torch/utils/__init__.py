"""Logging and timing of the port."""
