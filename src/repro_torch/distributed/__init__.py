"""Distribution layer of the port: gradient compression only (the
sharding rules and collectives wait for a multi-card slice)."""
