"""In-run failure supervision of the port (counterpart of
distribuuuu_tpu/resilience/)."""
