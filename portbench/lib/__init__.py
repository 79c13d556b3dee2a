"""The benchmark's harness: manifest, traffic, timing, trace reduction and the yardstick."""
