"""Data path of the port: the val transforms of the serving path."""
