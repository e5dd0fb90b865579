"""Vertex programs over the engines (PageRank)."""
