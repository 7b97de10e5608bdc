"""DLRM configs of the port (dlrm-qr, dlrm-dense and their smoke sizes)."""
