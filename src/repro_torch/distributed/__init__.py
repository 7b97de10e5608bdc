"""Distributed runtime of the port (so far the serving heartbeat,
``elastic.Heartbeat``)."""
