"""The benchmark's harness: manifest, traffic, cells, trace reading."""
