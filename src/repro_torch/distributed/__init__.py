"""Meshes, logical sharding rules and the collectives the port writes by
hand (the counterpart of ``repro/distributed``)."""
