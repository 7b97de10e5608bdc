"""Training of the port: the AdamW optimizer and the DLRM train step."""
