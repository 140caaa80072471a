"""Distribution layer of the port: the logical sharding rules
(`sharding`: specs, DTensor placements on a DeviceMesh, local shards
under a live mesh), the ranks and their collectives over named mesh
axes (`runtime`), and gradient compression."""
