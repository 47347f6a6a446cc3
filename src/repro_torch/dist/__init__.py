"""Distribution substrate: sharding plans over a mesh's positions."""
