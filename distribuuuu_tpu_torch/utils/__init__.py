"""Utilities of the port: logging and weight loading."""
