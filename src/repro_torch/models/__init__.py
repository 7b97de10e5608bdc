"""Models of the port (DLRM serving head)."""
