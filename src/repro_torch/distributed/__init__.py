"""Distribution layer of the port: the logical sharding rules
(`sharding`: specs, DTensor placements on a DeviceMesh) and gradient
compression.  Sharded execution, with collectives across cards, comes
after them."""
