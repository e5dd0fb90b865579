"""Host-side graph containers, generators, file format and device shards."""
