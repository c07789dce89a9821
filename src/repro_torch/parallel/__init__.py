"""Sharding rules: logical axes to DTensor placements over a device mesh."""
