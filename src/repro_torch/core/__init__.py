"""Core structures of the port: key bits, flat layouts, the deterministic
skiplist and the fixed-slot hash table."""
