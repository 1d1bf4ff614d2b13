"""The port's benchmark: harness, plain reference and yardstick."""
