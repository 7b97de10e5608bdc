"""Distributed runtime of the port: the logical-axis rules and the rank's
local shards (``sharding``), the collectives over a mesh axis and their
int8 compression (``collectives``), the serving heartbeat
(``elastic.Heartbeat``)."""
