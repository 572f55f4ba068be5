"""The (bands, time) mesh layer: placement, halo exchange, collectives and
the sharded block steps."""
