"""Part placement across hosts: ``parallel.placement.PlacementTree``."""
