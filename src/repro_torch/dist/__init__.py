"""Distributed pieces of the port.  Only gradient compression
(``collectives.py``) is ported so far; the ring and hierarchical
collectives, sharding and fault handling wait for ROADMAP.md Queue 1
item 5."""
