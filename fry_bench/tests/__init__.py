"""The benchmark's own tests."""
