"""Part placement and the distributed pull engines: the PlacementTree and
halo collectives (placement), the parts group (mesh), the process-group
start-up (multihost), the allgather, ring, reduce-scatter and block-CSR
engines (dist, ring, scatter, pallas_dist) and the rank launcher (spawn)."""
