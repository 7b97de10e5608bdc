"""Synthetic long-tail traces and DLRM batches of the port."""
